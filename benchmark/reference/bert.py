"""BERT encoder (bge-large-en's architecture: post-LayerNorm blocks, exact
gelu, absolute positions, token type 0, CLS pooling, L2-normalised), float32,
from the leaves ``benchmark/inputs.py::bert_weights`` makes.

A sequence is run at its real length: padding keys would get exactly zero
attention weight, so leaving them out changes no number. With a ``Drop``
(``dropout.py``) the call drops out at HF BERT's four sites, ``rows`` being
the sequences' rows in the call whose masks it holds.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from .precision import Matmul


def _layer_norm(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _drop(drop, site, x, rows):
    return x if drop is None else drop.apply(site, x, rows)


def _layer(w, i, c, x, mm: Matmul, drop=None, rows=None):
    p = f"layers.{i}."
    b, s, h = x.shape
    nh = c["num_attention_heads"]
    hd = h // nh

    def lin(t, name):
        return mm.mm(t, w[p + name + "_w"].float()) + w[p + name + "_b"].float()

    q, k, v = (lin(x, n).reshape(b, s, nh, hd) for n in ("q", "k", "v"))
    logits = mm.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
    probs = _drop(drop, 1 + 3 * i, torch.softmax(logits, dim=-1), rows)
    ctx = mm.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, h)
    eps = c["layer_norm_eps"]
    a = _drop(drop, 2 + 3 * i, lin(ctx, "o"), rows)
    x = _layer_norm(x + a, w[p + "attn_ln_scale"].float(),
                    w[p + "attn_ln_bias"].float(), eps)
    f = torch.nn.functional.gelu(lin(x, "ffn_in"), approximate="none")
    f = _drop(drop, 3 + 3 * i, lin(f, "ffn_out"), rows)
    return _layer_norm(x + f, w[p + "ffn_ln_scale"].float(),
                       w[p + "ffn_ln_bias"].float(), eps)


def encode(w: dict, c: dict, ids: torch.Tensor, mm: Matmul,
           checkpoint: bool = False, drop=None, rows=None) -> torch.Tensor:
    """(B, S) token ids of equal real length -> (B, H) float32 CLS
    embeddings, L2-normalised. Ids past the table read its last row."""
    s = ids.shape[1]
    ids = ids.long().clamp(0, c["vocab_size"] - 1)
    pos = torch.arange(s, device=ids.device).clamp(
        max=c["max_position_embeddings"] - 1)
    x = (w["embed.word"].float()[ids] + w["embed.position"].float()[pos][None]
         + w["embed.type"].float()[0][None, None])
    x = _layer_norm(x, w["embed.ln_scale"].float(), w["embed.ln_bias"].float(),
                    c["layer_norm_eps"])
    x = _drop(drop, 0, x, rows)
    for i in range(c["num_hidden_layers"]):
        if checkpoint and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _layer, w, i, c, x, mm, drop, rows, use_reentrant=False)
        else:
            x = _layer(w, i, c, x, mm, drop, rows)
    cls = x[:, 0]
    return cls / torch.linalg.vector_norm(cls, dim=-1,
                                          keepdim=True).clamp_min(1e-12)


def encode_rows(w: dict, c: dict, rows: list, mm: Matmul, device,
                checkpoint: bool = False, block_tokens: int = 65_536,
                drop=None):
    """Token id lists of any lengths -> (len(rows), H) embeddings in row
    order, rows of one length run together in blocks of at most
    ``block_tokens`` tokens; row ``j`` takes row ``j`` of ``drop``'s
    masks."""
    out = [None] * len(rows)
    by_len: dict[int, list[int]] = {}
    for j, r in enumerate(rows):
        by_len.setdefault(len(r), []).append(j)
    for n, idx in by_len.items():
        step = max(1, block_tokens // max(n, 1))
        for lo in range(0, len(idx), step):
            part = idx[lo:lo + step]
            ids = torch.tensor([rows[j] for j in part], device=device)
            e = encode(w, c, ids, mm, checkpoint, drop, part)
            for j, row in zip(part, e):
                out[j] = row
    return torch.stack(out)
