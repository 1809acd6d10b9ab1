"""Mistral-7B-v0.1's decoder (RMSNorm, rotary positions on half-split
heads, grouped-query attention, SwiGLU, untied head) with LoRA adapters on
its seven projections, float32, from the leaves ``benchmark/inputs.py``
makes. The published ``sliding_window`` of 4,096 masks nothing at the
cells' rows of at most 512 tokens, so plain causal attention is the model
there.

``row_ce`` is the reference recipe's per-candidate generator loss
(``src/rag.py:1338-1366``): next-token cross entropy over the target
tokens, divided by their number. With a ``Drop`` (``dropout.py``) each
layer drops out its attention probabilities, row ``j`` taking row ``j`` of
the masks.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from .precision import Matmul


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """x (B, S, N, D): rotate the two halves of each head by the angle of
    its position."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _weight(base, lora, name, scale):
    """W + scale * A @ B in float32."""
    w = base[name].float()
    if lora is None:
        return w
    ab = lora[name]
    return w + scale * (ab["A"] @ ab["B"])


def _block(base, lora, x, positions, bias, c, mm: Matmul, scale, i=0,
           drop=None):
    b, s, h = x.shape
    nh, nkv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                   c["head_dim"])
    eps = c["rms_norm_eps"]

    def w(name):
        return _weight(base, lora, name, scale)

    y = _rms(x, base["attn_norm"].float(), eps)
    q = mm.mm(y, w("q_w")).reshape(b, s, nh, hd)
    k = mm.mm(y, w("k_w")).reshape(b, s, nkv, hd)
    v = mm.mm(y, w("v_w")).reshape(b, s, nkv, hd)
    q = _rope(q, positions, c["rope_theta"])
    k = _rope(k, positions, c["rope_theta"])
    rep = nh // nkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = mm.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd) + bias
    probs = torch.softmax(logits, dim=-1)
    if drop is not None:
        probs = drop.apply(i, probs, range(b))
    ctx = mm.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, nh * hd)
    x = x + mm.mm(ctx, w("o_w"))
    y = _rms(x, base["mlp_norm"].float(), eps)
    g = torch.nn.functional.silu(mm.mm(y, w("gate_w")))
    return x + mm.mm(g * mm.mm(y, w("up_w")), w("down_w"))


def row_ce(weights: dict, lora: dict | None, c: dict, ids: torch.Tensor,
           mask: torch.Tensor, labels: torch.Tensor, mm: Matmul,
           lora_scale: float, logit_temp: float = 1.0,
           drop=None) -> torch.Tensor:
    """(R, S) right-padded rows -> (R,) length-normalised CE. ``labels``
    holds -100 where no target is scored; logits at position t score the
    token at t + 1. Each block is recomputed in the backward pass."""
    s = ids.shape[1]
    positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=ids.device))
    bias = torch.where(causal[None, None] & mask[:, None, None, :].bool(),
                       0.0, -1e9)
    x = weights["embed"].float()[ids.long()]
    for i, base in enumerate(weights["layers"]):
        lo = None if lora is None else lora["layers"][i]
        if torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _block, base, lo, x, positions, bias, c, mm, lora_scale, i,
                drop, use_reentrant=False)
        else:
            x = _block(base, lo, x, positions, bias, c, mm, lora_scale, i,
                       drop)
    x = _rms(x, weights["final_norm"].float(), c["rms_norm_eps"])
    targets = labels[:, 1:].long()
    valid = targets != -100
    rows, cols = torch.nonzero(valid, as_tuple=True)
    logits = mm.mm(x[:, :-1][rows, cols], weights["lm_head"].float())
    logp = torch.log_softmax(logits / logit_temp, dim=-1)
    tok = logp.gather(1, targets[rows, cols][:, None])[:, 0]
    nll = torch.zeros(ids.shape[0], dtype=torch.float32,
                      device=ids.device).index_add(0, rows, -tok)
    return nll / valid.sum(dim=1).clamp_min(1)
