"""The dropout masks' share of the device's idle time, over the traced window
(%): the device's idle time while the host was inside ``dropout.mask``
(``models/bert.py::dropout``: the CUDA generator's construction, the mask
draw, the ``where``; nested in the towers, the generator and the backward's
recompute) (``yardstick/spans.py::idle_under``); none where the trace holds
no device activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("dropout.mask",))
