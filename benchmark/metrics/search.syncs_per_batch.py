"""Host waits on the device inside a search call: CUDA runtime synchronisations
that start inside ``index.search``, over the ``search.batch`` ranges of the
trace (the batch's ``.cpu()`` lies outside)
(``yardstick/spans.py::calls_per``, the runtime events' names listed there);
none where the trace holds no device activity or none of the spans."""

from benchmark.yardstick import spans

WITHIN = ("index.search",)


def read(rec):
    return spans.calls_per(rec.window.trace, spans.SYNCS, WITHIN,
                           "search.batch")
