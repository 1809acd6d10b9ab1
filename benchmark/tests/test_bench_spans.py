"""``yardstick/spans.py`` on a trace made by hand: idle time under named
ranges, runtime calls inside them, counts; and every reader of a program
span reads nothing where its span is absent."""

from __future__ import annotations

import types

import pytest

from benchmark import harness
from benchmark.yardstick import spans
from benchmark.yardstick.trace import Trace

SPAN_READERS = [m["name"] for m in harness.manifest()["per_layer"]
                if m["source"] == "program_span"
                or m["name"].endswith(("_per_step", "_per_batch"))]


def _ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def _trace(extra=(), window_s=1e-3) -> Trace:
    """Kernels over [0, 100], [200, 300], [500, 600] us and a host op to
    1000 us: the device idles over [100, 200], [300, 500], [600, 1000]."""
    ev = [_ev("kernel", 0, 100), _ev("kernel", 200, 100),
          _ev("gpu_memcpy", 500, 100), _ev("cpu_op", 0, 1000, "aten::mm")]
    return Trace(ev + list(extra), window_s)


NAMED = [
    _ev("user_annotation", 150, 200, "A"),       # across two gaps: 50 + 50
    _ev("user_annotation", 160, 10, "A"),        # nested: counted once
    _ev("user_annotation", 400, 50, "B"),        # inside a gap: 50
    _ev("user_annotation", 550, 150, "B"),       # from a kernel on: 100
    _ev("user_annotation", 20, 60, "C"),         # under a kernel: 0
    _ev("cpu_op", 310, 100, "A"),                # an operator, not a span
    _ev("cuda_runtime", 160, 5, "cudaLaunchKernel"),
    _ev("cuda_runtime", 170, 5, "cudaStreamSynchronize"),
    _ev("cuda_runtime", 180, 5, "cudaMemcpyAsync"),
    _ev("cuda_runtime", 420, 5, "cuLaunchKernelEx"),
    _ev("cuda_runtime", 560, 5, "cudaLaunchKernelExC"),
    _ev("cuda_runtime", 800, 5, "cudaLaunchKernel"),   # outside every span
    _ev("cuda_runtime", 20, 5, "cudaDeviceSynchronize"),
]


def test_idle_intervals_take_the_edges_and_the_gaps():
    assert spans.idle(_trace()) == [(100, 200), (300, 500), (600, 1000)]
    tr = Trace([_ev("kernel", 50, 10), _ev("cpu_op", 0, 100, "op")], 1e-4)
    assert spans.idle(tr) == [(0, 50), (60, 100)]


def test_the_window_cuts_a_range_open_past_it():
    """A range open when the profiler stopped closes after the window: the
    idle time counted ends with the window."""
    tr = Trace([_ev("kernel", 50, 10), _ev("cpu_op", 0, 100, "op"),
                _ev("user_annotation", 80, 500, "A")], 1e-4)
    assert spans.idle(tr) == [(0, 50), (60, 100)]
    assert spans.idle_under(tr, ["A"]) == pytest.approx(20e-6)
    assert spans.idle_pct(tr, ["A"]) <= 100 * tr.idle_share()


def test_idle_under_named_ranges_by_hand():
    tr = _trace(NAMED)
    assert spans.idle_under(tr, ["A"]) == pytest.approx(100e-6)
    assert spans.idle_under(tr, ["B"]) == pytest.approx(150e-6)
    assert spans.idle_under(tr, ["C"]) == 0.0
    assert spans.idle_under(tr, ["A", "B", "C"]) == pytest.approx(250e-6)
    assert spans.idle_under(tr, ["D"]) == 0.0
    # the shares of disjoint spans sum to no more than the idle share
    assert spans.idle_pct(tr, ["A", "B"]) == pytest.approx(25.0)
    assert spans.idle_pct(tr, ["A", "B"]) <= 100 * tr.idle_share()


def test_runtime_calls_and_counts_by_hand():
    tr = _trace(NAMED)
    assert spans.runtime_calls(tr, spans.LAUNCHES, ["A"]) == 1
    assert spans.runtime_calls(tr, spans.LAUNCHES, ["B"]) == 2
    assert spans.runtime_calls(tr, spans.LAUNCHES, ["A", "B", "C"]) == 3
    assert spans.runtime_calls(tr, spans.SYNCS, ["A"]) == 1
    assert spans.runtime_calls(tr, spans.SYNCS, ["C"]) == 1
    assert spans.runtime_calls(tr, spans.SYNCS, ["B"]) == 0
    assert [spans.count(tr, n) for n in "ABCD"] == [2, 2, 1, 0]
    assert spans.calls_per(tr, spans.LAUNCHES, ["A", "B"], "B") == 1.5
    assert spans.calls_per(tr, spans.LAUNCHES, ["A"], "D") is None
    assert spans.calls_per(tr, spans.LAUNCHES, ["D"], "A") is None


def test_no_device_activity_reads_nothing():
    tr = Trace([e for e in NAMED if e["cat"] != "kernel"], 1e-3)
    assert spans.idle_pct(tr, ["A"]) is None
    assert spans.calls_per(tr, spans.LAUNCHES, ["A"], "A") is None
    assert spans.idle_pct(None, ["A"]) is None


def _record(trace):
    win = harness.Window(e2e={}, attempted=0, failed=0, window_s=1e-3,
                         trace=trace)
    return types.SimpleNamespace(ctx=None, window=win)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_reader_reads_nothing_without_its_span(name):
    read = harness.reader(name)
    assert read(_record(_trace(NAMED))) is None
    assert read(_record(None)) is None


def test_the_readers_read_the_program_spans():
    """Each reader, on a trace where its spans hold idle time, launches
    and synchronisations, reads them."""
    names = ["rag.build_batch", "jsa.towers", "jsa.generator", "jsa.mis",
             "step.grad", "step.update", "dropout.mask", "index.search",
             "build.wait_tokens", "build.h2d", "build.encode", "build.write"]
    ev = []
    for name in names + ["train.step", "search.batch"]:
        ev += [_ev("user_annotation", 150, 30, name),
               _ev("user_annotation", 400, 20, name)]
    ev += [_ev("cuda_runtime", 160, 1, "cudaLaunchKernel"),
           _ev("cuda_runtime", 405, 1, "cudaStreamSynchronize")]
    rec = _record(_trace(ev))
    for m in SPAN_READERS:
        got = harness.reader(m)(rec)
        want = {"%": 5.0, "launches": 0.5, "syncs": 0.5}[
            next(x["unit"] for x in harness.manifest()["per_layer"]
                 if x["name"] == m)]
        assert got == pytest.approx(want), m
