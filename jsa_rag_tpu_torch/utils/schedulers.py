"""LR schedules and the index-refresh scheduler (the port's copy of
``jsa_rag_tpu/utils/schedulers.py``).

``make_lr_schedule`` computes in float32 as the JAX package does
(``jnp.asarray(step, jnp.float32)``, python constants rounded to float32 at
each operation), so both packages give the same values; it returns a
0-dimensional float32 tensor. The cosine's ``cos`` is the C library's
``cosf``, which is what XLA's CPU backend lowers a float32 cosine to (torch's
vectorised cosine differs from it in the last bit for ~1% of arguments).
Semantics of the reference schedulers (src/util.py:67-112): warmup-linear
with floor ratio, half-period cosine decaying to a floor at total/2 then
flat, and fixed after warmup. ``IndexRefreshScheduler`` (src/util.py:114-161) with its schedule grammar
("start-end:rate,...", plain int sugar, -1 = never).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import logging
import math

import torch

logger = logging.getLogger(__name__)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@functools.cache
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cos_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine of a scalar tensor by ``cosf``."""
    return _f32(_libm_cosf()(float(x)))


def make_lr_schedule(kind: str, lr: float, warmup: int, total: int,
                     ratio: float = 0.1):
    """Returns a schedule fn step -> lr (a float32 scalar tensor)."""
    warmup = max(1, warmup)

    if kind == "linear":
        def fn(step):
            s = _f32(step)
            warm = (1 - ratio) * s / warmup + ratio
            decay = torch.clamp_min(
                1.0 + (ratio - 1) * (s - warmup) / max(1.0, total - warmup),
                0.0)
            return lr * torch.where(s < warmup, warm, decay)
        return fn
    if kind == "cosine":
        # reference: cos half-period from warmup to total*0.5, then floor
        def fn(step):
            s = _f32(step)
            half = total * 0.5
            warm = s / warmup
            t = (s - warmup) / torch.clamp_min(_f32(half - warmup), 1.0)
            cos = ratio + (1.0 - ratio) * _cos_f32(0.5 * math.pi * t)
            val = torch.where(s < warmup, warm,
                              torch.where(s < half, cos, _f32(ratio)))
            return lr * val
        return fn
    if kind == "fixed":
        def fn(step):
            s = _f32(step)
            return lr * torch.where(s < warmup, s / warmup, _f32(1.0))
        return fn
    raise ValueError(f"unknown scheduler {kind!r}")


_NEVER = 2 ** 32  # a window span/period no real run reaches


@dataclasses.dataclass(frozen=True)
class _RefreshWindow:
    """One ``start-end:rate`` piece of a refresh schedule: inside
    [start, stop) the index refreshes every ``every`` steps, counted from
    the window's own start."""
    start: int
    stop: int
    every: int

    def covers(self, step: int) -> bool:
        return self.start <= step < self.stop

    def fires(self, step: int) -> bool:
        return (step - self.start) % self.every == 0


def parse_refresh_schedule(spec: str) -> list[_RefreshWindow]:
    """Parse the ``--refresh_index`` grammar: comma-separated
    ``start-end:rate`` windows (e.g. ``0-100:10,100-1000000:500``), with two
    sugars — a bare integer means "every N steps forever" and ``-1`` means
    "never"."""
    if spec == "-1":
        return [_RefreshWindow(0, _NEVER, _NEVER)]
    if spec.isdigit():
        return [_RefreshWindow(0, _NEVER, int(spec))]
    windows = []
    for piece in spec.split(","):
        span, _, every = piece.partition(":")
        start, _, stop = span.partition("-")
        windows.append(_RefreshWindow(int(start), int(stop), int(every)))
    return windows


class IndexRefreshScheduler:
    """Decides, per training step, whether the in-loop index rebuild runs:

    - step 0 (the initial build) may always refresh;
    - a run that never trains the retriever never refreshes after that;
    - steps inside ``--freeze_retriever_steps`` are skipped;
    - otherwise the window covering the step decides via its rate;
    - a step past the end of the schedule logs a warning and does not
      refresh.
    """

    def __init__(self, spec: str, freeze_retriever_steps: int,
                 train_retriever: bool):
        self.spec = spec
        self.windows = parse_refresh_schedule(spec)
        self.freeze_retriever_steps = freeze_retriever_steps
        self.train_retriever = train_retriever

    def is_time_to_refresh(self, step: int) -> bool:
        if step != 0 and (not self.train_retriever
                          or step < self.freeze_retriever_steps):
            return False
        window = next((w for w in self.windows if w.covers(step)), None)
        if window is None:
            logger.warning(
                "step %d is beyond the refresh schedule %r; not refreshing",
                step, self.spec)
            return False
        return window.fires(step)
