"""The precision every product of the reference is computed in.

``f32``: float32 operands and sums, TF32 off. The control, ``fp8``,
rounds both operands first to e4m3 with one scale per operand (its largest
magnitude maps to 448) and sums in float32. Rounding by hand gives the
same numbers on the CPU and on the card.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` through e4m3 with one scale for the tensor."""
    x = x.to(torch.float32)
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Matmul:
    """``mm(a, b)`` and ``einsum(eq, a, b)`` with both operands rounded to
    ``kind`` (f32 | fp8) and float32 sums. The rounding is a
    straight-through estimator: the backward sees the identity, as the
    reference's float32 backward would."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.kind == "f32":
            return x
        return x + (round_fp8(x.detach()) - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._round(a) @ self._round(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self._round(a), self._round(b))
