"""The BERT tower's attention without autograd: one hand-written CUDA kernel.

``bert_attention(q, k, v, bias)`` computes ``softmax(q kᵀ / √hd + bias) v``
for every sequence and head of one layer, the function of its composed plain
version ``_attention_plain`` without dropout. It replaces no Pallas
kernel: the JAX package's BERT attention is plain XLA. It exists because the
composed version writes the (B, nh, S, S) f32 logits and their softmax to
device memory: ~7 GB a layer at the rebuild's B = 256, S = 192. The kernel
(``csrc/bert_attention.cu``) reads q, k and v once where the projections
left them and writes the context once, in (B, S, H); at that shape its bound
is those 403 MB (bytes, 120 us a layer at 3.35 TB/s), not its 38.7 GFLOP.
See the source for the design.

``models/bert.py::BertLayer._attention`` calls it for CUDA tensors of a
16-bit activation dtype when nothing requires grad and no dropout seed is
given; every other call takes the composed code.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ._build import load_libraries

KERNEL = "bert_attention"
HEAD_DIMS = range(16, 129, 16)  # head sizes the kernel is built for


def _attention_plain(q, k, v, bias, drop=None):
    """``softmax(q kᵀ / √hd + bias) v`` over (B, S, nh, hd) heads, composed:
    f32 logits (exact products of the activation dtype, f32 sums), the
    probabilities in the activation dtype, then ``drop`` (the layer's
    attention-probs dropout, a function of the probabilities) if given ->
    (B, S, nh * hd). The path on the CPU, under grad, with dropout or in
    f32, and the yardstick of the fused kernel."""
    b, s, nh, hd = q.shape
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    if drop is not None:
        probs = drop(probs)
    return torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, nh * hd)


@functools.cache
def _lib() -> ctypes.CDLL:
    """``csrc/bert_attention.cu``, built at first use."""
    lib = load_libraries((KERNEL,))[KERNEL]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bert_attention_launch.argtypes = ([ptr] * 5 + [i32] * 6
                                          + [ctypes.c_float, ptr])
    lib.bert_attention_launch.restype = i32
    lib.bert_attention_resident.argtypes = [i32, i32]
    lib.bert_attention_resident.restype = i32
    return lib


def _check(q, k, v, bias) -> None:
    """What the kernel refuses: raise rather than compute elsewhere."""
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"bert_attention takes bf16 or fp16, not {q.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share one (B, S, nh, hd) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, nh, hd = q.shape
    if any(t.dtype != q.dtype or t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must share a dtype and a device")
    if hd not in HEAD_DIMS:
        raise ValueError(f"bert_attention takes a head size in "
                         f"{list(HEAD_DIMS)}, not {hd}")
    if b < 1 or s < 1 or b * nh >= 2 ** 31:
        raise ValueError(f"bert_attention grid out of range: B={b}, S={s}, "
                         f"nh={nh}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous (B, S, nh, hd) views "
                         "of (B, S, H) rows")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if (bias.dtype != torch.float32 or bias.device != q.device
            or tuple(bias.shape) != (b, 1, 1, s) or not bias.is_contiguous()):
        raise ValueError(f"the mask bias must be a contiguous (B, 1, 1, S) "
                         f"f32 tensor beside q, not {tuple(bias.shape)} "
                         f"{bias.dtype}")


def kv_resident(s: int, hd: int) -> bool:
    """Whether a head's K and V stay in shared memory for its whole block at
    sequence length ``s`` (else they stream through one 64-key stage)."""
    rc = _lib().bert_attention_resident(int(s), int(hd))
    if rc < 0:
        raise ValueError(f"bert_attention: no block fits S={s}, hd={hd}")
    return bool(rc)


def bert_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ / √hd + bias) v`` -> (B, S, nh * hd) in q's dtype.

    q, k, v: (B, S, nh, hd), contiguous views of the projections' (B, S, H)
    outputs; bias: the (B, 1, 1, S) f32 mask bias. CPU tensors take the
    composed version (``_attention_plain``); CUDA tensors launch
    ``csrc/bert_attention.cu`` (counted in ``bert_attention.launches``) or
    raise — there is no fallback."""
    if q.device.type == "cpu":
        return _attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, bias)
    b, s, nh, hd = q.shape
    out = torch.empty((b, s, nh * hd), dtype=q.dtype, device=q.device)
    # the composed path divides the f32 logits by √hd as a multiply by the
    # f32 reciprocal
    scale = float(np.float32(1.0) / np.float32(np.sqrt(hd)))
    with torch.cuda.device(q.device):
        rc = _lib().bert_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, s, nh, hd, nh * hd,
            int(q.dtype == torch.float16), scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bert_attention launch failed: cudaError {rc}")
    bert_attention.launches += 1
    return out


bert_attention.launches = 0
