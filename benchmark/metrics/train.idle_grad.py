"""The backward's share of the device's idle time, over the traced window (%):
the device's idle time while the host was inside ``step.grad``
(``train/rag_model.py``: ``torch.autograd.grad``, with the remat recompute)
(``yardstick/spans.py::idle_under``); none where the trace holds no device
activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("step.grad",))
