"""A ``torch.profiler`` trace of a few steady steps, reduced to what the
per-layer metrics read: the device's busy time (the union of its activity
intervals), the traced window, device time by kernel name, and the longest
idle gaps named by what the host was doing.

Copied arithmetic: the idle share is ``train/loop.py::StepProfiler``'s
(1 - union of kernel intervals / window), taken here from the chrome
trace the profiler exports, whose format is stable across torch versions.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "python_function")


class Trace:
    """Device intervals and host ranges of one traced window, in
    microseconds on the trace's clock; ``window_s`` is the host's span of
    the window, which starts and ends with the device synchronised."""

    def __init__(self, events: list[dict], window_s: float):
        self.window_s = float(window_s)
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("name", ""))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS and float(e.get("dur", 0)) > 0)
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                      e.get("name", ""), e.get("cat"))
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS]

    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device: the union of
        the device intervals."""
        busy, end = 0.0, None
        for s, e, _ in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-6

    def idle_share(self) -> float | None:
        """1 - busy / window, or None where the trace holds no device
        activity (a profiler that saw no device time)."""
        if not self.device or self.window_s <= 0:
            return None
        return max(0.0, 1.0 - self.busy_s() / self.window_s)

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        ``pattern``."""
        hits = [e - s for s, e, n in self.device if pattern in n]
        return sum(hits) * 1e-6, len(hits)

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [[name, seconds]]."""
        by: dict[str, float] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest gaps between device activity, each named by the
        innermost harness span (else operator) the host was inside at the
        gap's middle, else "host": [[name, seconds]]."""
        gaps, end = [], None
        for s, e, _ in self.device:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for dur, a, b in gaps[:top]:
            mid = (a + b) / 2
            inside = [h for h in self.host if h[0] <= mid <= h[1]]
            name = "host"
            if inside:
                ann = [h for h in inside if h[3] == "user_annotation"]
                name = min(ann or inside, key=lambda h: h[1] - h[0])[2]
            out.append([name, dur * 1e-6])
        return out


class Capture:
    """``start()`` a profiler with CPU and (on the card) CUDA activities,
    ``stop()`` it; once the measured window has closed, ``trace()`` exports
    and reads it -> ``Trace`` (the export takes seconds, and stays out of the
    window). The caller synchronises the device before ``start`` and
    ``stop``, so the traced window is the host's span between them.
    ``pause_s`` is the time ``start`` and ``stop`` themselves took, which a
    measured window leaves out."""

    def __init__(self, device_type: str):
        self.device_type = device_type
        self.prof = None
        self.t0 = 0.0
        self.window = None
        self.pause_s = 0.0

    def start(self) -> None:
        import torch

        t = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.pause_s += self.t0 - t

    def stop(self) -> None:
        t = time.perf_counter()
        self.window = t - self.t0
        self.prof.__exit__(None, None, None)
        self.pause_s += time.perf_counter() - t

    def trace(self) -> Trace | None:
        if self.window is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.prof = None
        return Trace(events, self.window)


def span(name: str):
    """A host range the trace names idle gaps by."""
    import torch

    return torch.profiler.record_function(name)
