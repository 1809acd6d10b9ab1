"""Device policy of the port: the caller names the device, nothing guesses.

Every entry point takes ``device`` (default ``"cuda"``). A request for CUDA
on a machine without it raises instead of running on the CPU, so a result can
never silently come from the wrong device. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def exact_f32_matmul() -> None:
    """Pin float32 products to full float32 on the card: the GPU form of the
    TPU's HIGHEST-precision rule for the exact oracle and the refine
    (TF32 keeps ~3 decimal digits, which would turn the "exact" oracle into
    an approximate one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
