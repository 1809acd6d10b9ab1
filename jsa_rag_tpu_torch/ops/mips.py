"""Exact f32 maximum-inner-product search (the oracle) and the dense
index's search dispatch.

Counterpart of ``jsa_rag_tpu/ops/mips.py`` (:55-270): ``mips_topk_exact``
over row-major (N, d) embeddings and ``mips_topk_xla_t`` over a transposed
(d, N) index with a runtime valid count. Both stream the index in column
chunks and carry a running (B, k) top-k, so a 1.3M x 1024 corpus never
materialises a (B, N) score matrix. On the card the products run in full
f32 with TF32 off — the GPU form of the TPU's HIGHEST-precision rule, which
keeps the oracle exact. ``mips_topk_t`` dispatches a bf16/f32/fp16 flat
index's search by the JAX package's method names, ``mips_topk`` a row-major
(N, d) search (``mips.py:276-328``, the benches' entry).
``mips_topk_approx`` and the ``"approx"`` methods keep the JAX package's
signature and chunking (``mips.py:117-200``), but ``lax.approx_max_k`` is a
TPU hardware op and, off the TPU, an exact top-k: the port ships the exact
chunked scan with the exact running merge, so its recall is 1 for any
``recall_target``.
"""

from __future__ import annotations

from typing import Literal

import torch

from .mips_stream import mips_topk_stream
from .mips_topt import (_scan_cols, mips_topk_dense, mips_topk_dense_t,
                        mips_topk_f16, mips_topk_f16_t)

Method = Literal["auto", "exact", "approx", "pallas", "pallas2"]

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


def mips_topk_approx(queries: torch.Tensor, embeddings: torch.Tensor,
                     k: int, chunk: int = 262144,
                     recall_target: float = 0.99,
                     valid_n: int | None = None):
    """Top-k over (N, d) rows in chunks of ``chunk``, rows at or past
    ``valid_n`` masked (``mips.py:117-143``, and the valid count of
    ``mips_topk_xla_t(approx=True)``, :150-200). The TPU selects each chunk
    with ``lax.approx_max_k`` at ``recall_target``; here every chunk is
    merged exactly into the running (B, k), so the end-to-end recall (1) is
    at least any ``recall_target``. The chunk products run in f32 (TF32 off
    on the card), where the TPU's DEFAULT precision took one bf16 pass.
    -> (scores (B, k) f32, ids (B, k) int32), sorted descending."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got "
                         f"{recall_target}")
    n = embeddings.shape[0]
    nv = n if valid_n is None else int(valid_n)
    return _scan_cols(
        queries, lambda s, w: embeddings[s:s + w].to(torch.float32).T,
        n, min(k, n), chunk, nv)


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
                recall_target: float = 0.99, valid_n: int | None = None,
                pool_n: int | None = None, refine: int = 4):
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
    ``"auto"`` on the CPU, the f32 scan over the stored fp16 values.
    ``"approx"`` (any dtype; ``mips_topk_xla_t(approx=True)``,
    ``mips.py:150-200``): ``mips_topk_approx`` with the valid count, in
    chunks of 262,144."""
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
        return mips_topk_approx(queries, emb_rows, k, chunk=chunk or 262144,
                                recall_target=recall_target, valid_n=valid_n)
    raise ValueError(f"unknown MIPS method {method!r}")


def mips_topk(queries: torch.Tensor, embeddings: torch.Tensor, k: int, *,
              method: Method = "auto", chunk: int | None = None,
              recall_target: float = 0.99):
    """Row-major MIPS (counterpart of ``mips_topk``, ``mips.py:276-328``):
    ``embeddings`` (N, d) bf16, f32 or fp16, every row valid. -> (scores
    (B, k) f32, ids (B, k) int32), sorted descending.

    fp16 rows (the JAX int16-bits branch, ``mips.py:288-301``): ``"auto"``,
    ``"pallas"`` and ``"pallas2"`` run ``mips_topk_f16`` (kernel B7 on a
    CUDA tensor); ``"exact"`` the f32 scan over the stored values.
    Otherwise ``"exact"`` is ``mips_topk_exact``, ``"pallas"`` the exact
    streaming top-k ``mips_topk_stream`` (kernel B9), ``"pallas2"`` the
    per-tile top-T scan ``mips_topk_dense`` (kernel B6), and ``"auto"``
    B6 on a CUDA tensor from ``AUTO_FUSED_MIN_ROWS`` rows and ``"exact"``
    below that or on the CPU (``auto_method``). ``"approx"`` is
    ``mips_topk_approx`` (over fp16 rows too); ``"auto"`` never picks it."""
    if embeddings.dtype == torch.int16:
        raise TypeError("fp16 rows are torch.float16 here, not int16 bits")
    if embeddings.dtype == torch.float16 and method in ("auto", "pallas",
                                                        "pallas2"):
        return mips_topk_f16(queries, embeddings, k)
    if method == "auto":
        method = auto_method(embeddings.device.type, embeddings.shape[0])
    if method == "exact":
        return mips_topk_exact(queries, embeddings, k, chunk=chunk or 16384)
    if method == "pallas":
        return mips_topk_stream(queries, embeddings, k)
    if method == "pallas2":
        return mips_topk_dense(queries, embeddings, k)
    if method == "approx":
        return mips_topk_approx(queries, embeddings, k, chunk=chunk or 262144,
                                recall_target=recall_target)
    raise ValueError(f"unknown MIPS method {method!r}")
