"""The rebuild's share of the card's peak: the passage tower's forward
operations of every passage written in the window, from each passage's own
token count (``yardstick/flops.py::bert_forward_flops``, no padding), at
989 TFLOP/s, over the window's seconds (%)."""

from benchmark.yardstick import peaks


def read(rec):
    w = rec.window
    if not w.work.get("bf16"):
        return None
    return 100.0 * w.work["bf16"] / peaks.BF16_FLOPS / w.window_s
