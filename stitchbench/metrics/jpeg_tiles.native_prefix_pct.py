"""The program's counters over the window: the share of the JPEG tiles
opened by the device decode tier (``decode_tiles_opened``) whose upload
came straight from the native Huffman scan's zigzag store
(``decode_tiles_native_prefix``), in percent. A tile that takes the
natural-order route gives the same bytes, only later, so the check cannot
see it; this share can. None where the program has no such counter."""


def read(trace):
    native = trace.counters.get("decode_tiles_native_prefix")
    opened = trace.counters.get("decode_tiles_opened")
    if native is None or not opened:
        return None
    return 100.0 * native / opened
