"""Host clock over the traced run's passes of the program's stream_bands()
(decode, layout, band assembly; no encoder), each paired with a whole job
in turns, per band."""


def read(trace):
    pairs = [p for p in trace.layer_pairs or () if p["decode_bands"]]
    if not pairs:
        return None
    return sum(p["decode_s"] for p in pairs) / sum(p["decode_bands"] for p in pairs) * 1e3
