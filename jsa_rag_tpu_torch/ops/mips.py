"""Exact f32 maximum-inner-product search (the oracle) and the dense
index's search dispatch.

Counterpart of ``jsa_rag_tpu/ops/mips.py`` (:55-270): ``mips_topk_exact``
over row-major (N, d) embeddings and ``mips_topk_xla_t`` over a transposed
(d, N) index with a runtime valid count. Both stream the index in column
chunks and carry a running (B, k) top-k, so a 1.3M x 1024 corpus never
materialises a (B, N) score matrix. On the card the products run in full
f32 with TF32 off — the GPU form of the TPU's HIGHEST-precision rule, which
keeps the oracle exact. ``mips_topk_t`` dispatches a bf16/f32/fp16 flat
index's search by the JAX package's method names. The approximate variant
(``lax.approx_max_k``, a TPU hardware op) is not ported yet: ROADMAP queue A
item 14.
"""

from __future__ import annotations

from typing import Literal

import torch

from ..device import exact_f32_matmul
from .mips_topt import mips_topk_dense_t, mips_topk_f16_t

Method = Literal["auto", "exact", "approx", "pallas", "pallas2"]

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


AUTO_FUSED_MIN_ROWS = 16384


def auto_method(device_type: str, n: int) -> str:
    """``method="auto"``: the fused scan on the card for N >= 16384 rows,
    the exact chunked scan otherwise (the rule of ``mips.py:253-255``, with
    the card's own crossover: on an H100 80GB HBM3 at 700 W,
    ``chip_smoke.py`` phase 6 times one search of 8 queries over bf16 rows
    of d=1024, fused against exact, over two runs: 0.16-0.20 against
    0.14-0.21 ms at 4,096 rows, 0.20-0.30 against 0.22-0.30 ms at 16,384,
    0.32 against 0.58 ms at 32,768 and 0.21 against 0.85-0.88 ms at
    65,536, where the TPU's threshold sits)."""
    return ("pallas2" if device_type == "cuda" and n >= AUTO_FUSED_MIN_ROWS
            else "exact")


def mips_topk_t(queries: torch.Tensor, emb_rows: torch.Tensor, k: int, *,
                method: Method = "auto", chunk: int | None = None,
                valid_n: int | None = None, pool_n: int | None = None,
                refine: int = 4):
    """MIPS over a dense flat index (counterpart of ``mips_topk_t``,
    ``mips.py:214-270``): ``emb_rows`` (N, d) bf16, f32 or fp16, row-major
    here (the JAX package's is (d, N)). -> (scores (B, k), ids (B, k)).

    bf16/f32: ``"pallas"``/``"pallas2"`` run the fused scan (kernel B3 on a
    CUDA tensor, its plain version on a CPU one); ``"auto"`` picks it on
    CUDA for N >= 16384 and the exact chunked scan below that
    (``auto_method``); ``"exact"`` is the f32 oracle with the runtime valid
    count.
    fp16 (``mips.py:236-252``): ``"pallas"``/``"pallas2"``, and ``"auto"`` on
    CUDA at any N, run ``mips_topk_f16_t`` with ``refine`` (kernel B4 and the
    f32 rescore for refine > 0, kernel B5 for 0); ``"exact"``, and
    ``"auto"`` on the CPU, the f32 scan over the stored fp16 values."""
    n = emb_rows.shape[0]
    if emb_rows.dtype == torch.int16:
        raise TypeError("fp16 rows are torch.float16 here, not int16 bits")
    if emb_rows.dtype == torch.float16:
        if method in ("pallas", "pallas2") or (
                method == "auto" and emb_rows.device.type == "cuda"):
            return mips_topk_f16_t(queries, emb_rows, k, valid_n=valid_n,
                                   pool_n=pool_n, refine=refine)
        if method == "auto":
            method = "exact"
    if method == "auto":
        method = auto_method(emb_rows.device.type, n)
    if method in ("pallas", "pallas2"):
        return mips_topk_dense_t(queries, emb_rows, k, valid_n=valid_n,
                                 pool_n=pool_n)
    if method == "exact":
        nv = n if valid_n is None else int(valid_n)
        return _scan_cols(
            queries, lambda s, w: emb_rows[s:s + w].to(torch.float32).T,
            n, min(k, n), chunk or 16384, nv)
    if method == "approx":
        raise NotImplementedError(
            "approximate MIPS is not ported yet: ROADMAP queue A item 14")
    raise ValueError(f"unknown MIPS method {method!r}")
