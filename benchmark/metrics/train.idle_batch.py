"""The training batch's share of the device's idle time, over the traced window
(%): the device's idle time while the host was inside ``rag.build_batch``
(``train/rag_model.py``: both query towers, the search, the ids' copy to the
host, the union, the tokenisation) (``yardstick/spans.py::idle_under``);
none where the trace holds no device activity or no such span."""

from benchmark.yardstick import spans


def read(rec):
    return spans.idle_pct(rec.window.trace, ("rag.build_batch",))
