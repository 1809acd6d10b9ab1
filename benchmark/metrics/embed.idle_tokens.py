"""The rebuild's wait on the tokeniser, as a share of the device's idle time,
over the traced window (%): the device's idle time while the host was inside
``build.wait_tokens`` (``index/build.py``: the main thread blocked on the
tokenising thread's window) (``yardstick/spans.py::idle_under``); none where
the trace holds no device activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("build.wait_tokens",))
