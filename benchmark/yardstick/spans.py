"""What the program's own spans (``jsa_rag_tpu_torch/utils/trace.py``,
``record_function`` ranges on the profiler's clock) say in a ``Trace``: the
device's idle time under named host ranges, the CUDA runtime calls made
inside them, and how often a range occurs.

Everything reads ``Trace.device`` (the device's intervals) and
``Trace.host`` (host ranges with their category) as they stand, in
microseconds on the trace's clock. A span is a ``user_annotation`` range;
every range of a name counts, on whatever thread it was recorded, and
nested or repeated ranges count their union once.

The device is idle where none of its intervals runs inside the traced
window, laid on the trace's clock from its first event and ``window_s``
long: the gaps between the union of its intervals and the stretches before
the first and after the last. That is the idle time of ``device_idle.*``,
so the shares of disjoint spans sum to no more than it. A range still open
when the profiler stopped ends where it closed, past the window; the window
cuts it.

CUDA runtime calls are ``cuda_runtime`` events, matched by name prefix.
The names, as the cells' traces on an H100 (torch 2.11, CUDA 12.8) hold
them:

- launches: ``cudaLaunchKernel`` (PyTorch's kernels and the hand-written
  scans) and ``cudaLaunchKernelExC`` (cuBLAS); ``cuLaunchKernel`` covers
  the form Triton's launches take, which no cell makes;
- synchronisations: ``cudaStreamSynchronize`` (each copy between the
  device and pageable host memory: ``.cpu()``, ``.tolist()``, and
  ``.to(device)`` of a host tensor), ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``.

A call counts where it starts inside one of the named ranges, so the
backward's launches from the autograd thread count inside the main
thread's ``step.grad``.
"""

from __future__ import annotations

SPAN_CAT = "user_annotation"
RUNTIME_CAT = "cuda_runtime"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def _union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the same time."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs, ys) -> float:
    """Time two sorted, disjoint interval lists share."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _ranges(trace, names) -> list[tuple[float, float]]:
    names = set(names)
    return _union((s, e) for s, e, n, cat in trace.host
                  if cat == SPAN_CAT and n in names)


def idle(trace) -> list[tuple[float, float]]:
    """The device's idle intervals inside the traced window."""
    starts = [h[0] for h in trace.host] + [d[0] for d in trace.device]
    if not starts:
        return []
    t = min(starts)
    end = t + trace.window_s * 1e6
    out = []
    for a, b in _union(d[:2] for d in trace.device):
        if min(a, end) > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return out


def idle_under(trace, names) -> float:
    """Seconds in which the device was idle while the host was inside a
    range named one of ``names``."""
    return _overlap(idle(trace), _ranges(trace, names)) * 1e-6


def runtime_calls(trace, kinds, within) -> int:
    """CUDA runtime calls whose name starts with one of ``kinds`` and whose
    start lies inside a range named one of ``within``."""
    inside = _ranges(trace, within)
    starts = sorted(s for s, _, n, cat in trace.host
                    if cat == RUNTIME_CAT and n.startswith(tuple(kinds)))
    n, j = 0, 0
    for s in starts:
        while j < len(inside) and inside[j][1] < s:
            j += 1
        if j < len(inside) and inside[j][0] <= s:
            n += 1
    return n


def count(trace, name: str) -> int:
    """How many ranges named ``name`` the trace holds."""
    return sum(1 for _, _, n, cat in trace.host
               if cat == SPAN_CAT and n == name)


def _readable(trace, names) -> bool:
    """A trace with device activity and a range of one of ``names``."""
    return (trace is not None and bool(trace.device)
            and any(count(trace, n) for n in names))


def idle_pct(trace, names) -> float | None:
    """``idle_under`` over the traced window (%); none where there is no
    trace, no device activity in it or none of the ranges."""
    if not _readable(trace, names) or trace.window_s <= 0:
        return None
    return 100.0 * idle_under(trace, names) / trace.window_s


def calls_per(trace, kinds, within, per: str) -> float | None:
    """``runtime_calls`` inside ``within`` per range named ``per`` (a step,
    a batch); none where there is no trace, no device activity, none of
    the ranges or no ``per``."""
    if not _readable(trace, within) or not count(trace, per):
        return None
    return runtime_calls(trace, kinds, within) / count(trace, per)
