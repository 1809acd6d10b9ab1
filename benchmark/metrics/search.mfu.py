"""The searches' share of the card's peak: every search's int8 scan
products at 1,979 TOPS and its refine's f32 products at 67 TFLOP/s
(``yardstick/flops.py::int8r_search_ops``), over the window's seconds (%).
A count of the work, not of a kernel."""

from benchmark.yardstick import peaks


def read(rec):
    w = rec.window
    if not w.work.get("int8"):
        return None
    need = w.work["int8"] / peaks.INT8_OPS + w.work["f32"] / peaks.F32_FLOPS
    return 100.0 * need / w.window_s
