"""The rebuild's copies of token rows to the device, as a share of the device's
idle time, over the traced window (%): the device's idle time while the host
was inside ``build.h2d`` (``index/build.py``: each batch's
``torch.from_numpy(...).to(dev)``) (``yardstick/spans.py::idle_under``);
none where the trace holds no device activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("build.h2d",))
