"""The update's share of the device's idle time, over the traced window (%):
the device's idle time while the host was inside ``step.update``
(``train/step.py``: ``tx.step``, the clip norm and AdamW)
(``yardstick/spans.py::idle_under``); none where the trace holds no device
activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("step.update",))
