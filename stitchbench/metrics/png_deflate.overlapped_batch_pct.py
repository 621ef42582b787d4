"""The program's counters over the window: the share of the PNG writer's
deflate batches (``deflate_batches``) compressed on a worker while the
job's thread went on to the next band (``deflate_batches_overlapped``), in
percent. The bytes are the same wherever a batch compresses, so the check
cannot see it; this share can. None where the program has no such counter
or compressed no batch."""


def read(trace):
    overlapped = trace.counters.get("deflate_batches_overlapped")
    batches = trace.counters.get("deflate_batches")
    if overlapped is None or not batches:
        return None
    return 100.0 * overlapped / batches
