"""Exact f32 maximum-inner-product search: the oracle.

Counterpart of ``jsa_rag_tpu/ops/mips.py`` (:55-211): ``mips_topk_exact``
over row-major (N, d) embeddings and ``mips_topk_xla_t`` over a transposed
(d, N) index with a runtime valid count. Both stream the index in column
chunks and carry a running (B, k) top-k, so a 1.3M x 1024 corpus never
materialises a (B, N) score matrix. On the card the products run in full
f32 with TF32 off — the GPU form of the TPU's HIGHEST-precision rule, which
keeps the oracle exact. The approximate variant (``lax.approx_max_k``, a TPU
hardware op) is not ported yet: ROADMAP queue A item 14.
"""

from __future__ import annotations

import torch

from ..device import exact_f32_matmul

NEG_INF = float(torch.finfo(torch.float32).min)


def _scan_cols(queries, cols, n: int, k: int, chunk: int, valid_n: int):
    """``cols(start, width)`` -> (d, width) f32 chunk of the index."""
    if queries.device.type == "cuda":
        exact_f32_matmul()
    b = queries.shape[0]
    dev = queries.device
    q = queries.to(torch.float32)
    cs = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    ci = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, chunk):
        width = min(chunk, n - start)
        s = q @ cols(start, width)
        idx = torch.arange(start, start + width, dtype=torch.int32,
                           device=dev)
        s = torch.where(idx < valid_n, s, NEG_INF)
        all_s = torch.cat([cs, s], dim=1)
        all_i = torch.cat([ci, idx.expand(b, -1)], dim=1)
        cs, a = torch.topk(all_s, k, dim=1)
        ci = torch.gather(all_i, 1, a)
    return cs, ci


def mips_topk_exact(queries: torch.Tensor, embeddings: torch.Tensor,
                    k: int, chunk: int = 16384):
    """Exact top-k over (N, d) rows -> (scores (B, k) f32, ids (B, k)
    int32), sorted descending. Every row is a candidate."""
    n = embeddings.shape[0]
    k = min(k, n)
    return _scan_cols(
        queries, lambda s, w: embeddings[s:s + w].to(torch.float32).T,
        n, k, chunk, n)


def mips_topk_xla_t(queries: torch.Tensor, embeddings_t: torch.Tensor,
                    k: int, chunk: int = 16384, valid_n: int | None = None):
    """Exact top-k over a transposed (d, N) index; columns at or past
    ``valid_n`` are masked. Name kept from the JAX package, where it was
    the XLA (non-Pallas) path."""
    n = embeddings_t.shape[1]
    k = min(k, n)
    nv = n if valid_n is None else int(valid_n)
    return _scan_cols(
        queries, lambda s, w: embeddings_t[:, s:s + w].to(torch.float32),
        n, k, chunk, nv)
