"""Kernel launches a training step: CUDA runtime launch calls, on any thread,
that start inside ``rag.build_batch``, ``step.loss``, ``step.grad`` or
``step.update``, over the ``train.step`` ranges of the trace
(``yardstick/spans.py::calls_per``, the runtime events' names listed there);
none where the trace holds no device activity or none of the spans."""

from benchmark.yardstick import spans

WITHIN = ("rag.build_batch", "step.loss", "step.grad", "step.update")


def read(rec):
    return spans.calls_per(rec.window.trace, spans.LAUNCHES, WITHIN,
                           "train.step")
