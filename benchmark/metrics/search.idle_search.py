"""The search call's share of the device's idle time, over the traced window
(%): the device's idle time while the host was inside ``index.search``
(``index/flat.py``: the queries' copy, the gather, the scan, merge and
refine) (``yardstick/spans.py::idle_under``); none where the trace holds no
device activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("index.search",))
