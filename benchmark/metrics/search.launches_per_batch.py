"""Kernel launches a search batch: CUDA runtime launch calls that start inside
``index.search``, over the ``search.batch`` ranges of the trace
(``yardstick/spans.py::calls_per``, the runtime events' names listed there);
none where the trace holds no device activity or none of the spans."""

from benchmark.yardstick import spans

WITHIN = ("index.search",)


def read(rec):
    return spans.calls_per(rec.window.trace, spans.LAUNCHES, WITHIN,
                           "search.batch")
