"""The searches' bytes (``yardstick/flops.py::int8r_search_bytes``: plane 1
and its scales read once, the candidates' plane-2 rows, queries in,
answers out) at 3.35 TB/s, over the window's seconds (%): the bytes term
beside ``search.mfu``."""

from benchmark.yardstick import peaks


def read(rec):
    w = rec.window
    if not w.work.get("bytes"):
        return None
    return 100.0 * w.work["bytes"] / peaks.HBM_BYTES_PER_S / w.window_s
