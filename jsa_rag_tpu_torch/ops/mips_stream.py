"""Exact fused MIPS top-k: the streaming kernel B9 and its plain version.

Counterpart of ``jsa_rag_tpu/ops/mips_pallas.py``: ``mips_topk_pallas``
(:93-161) and its Pallas kernel ``_mips_kernel`` (:38-90), which carries a
sorted running top-k across the N tiles in VMEM. Here the CUDA kernel
``csrc/mips_stream.cu`` splits the rows into slices, keeps an exact running
top-k of each slice per query in shared memory, and the wrapper merges the
slices' (S, B, k) candidates exactly (``mips_topt._merge_candidates``); the
source explains the design and why it is exact.
"""

from __future__ import annotations

import torch

from .mips_topt import (_kernel_libs, _merge_candidates, _scan_cols,
                        split_hilo_bf16)

STREAM_DTYPES = (torch.bfloat16, torch.float32)
STREAM_TILE = 256  # index rows a block scores at a time
SM_SMEM = 233_472  # an SM's shared memory; each resident block reserves 1 KB


def stream_smem(dtype: torch.dtype) -> tuple[int, int]:
    """(the shared memory a block of kernel B9 takes besides its lists, the
    most a block may take) for ``dtype`` rows, as ``csrc/mips_stream.cu``
    lays them out (``mips_stream_fixed_smem``, ``mips_stream_max_smem``)."""
    lib = _kernel_libs()["mips_stream"]
    return (lib.mips_stream_fixed_smem(int(dtype == torch.float32)),
            lib.mips_stream_max_smem())


def stream_geometry(b: int, n: int, k: int, fixed_smem: int, max_smem: int,
                    sms: int):
    """How kernel B9 cuts its work -> (queries a block, slices, tiles a
    slice). A block keeps a k-slot list a query in shared memory beside
    ``fixed_smem`` bytes (``stream_smem``), so it takes qpb = min(32,
    budget // (8 k)) queries; the N tiles are cut into as many slices as
    fill the ``sms`` SMs once (two blocks an SM where two fit). A k whose
    one-query list does not fit raises ``ValueError`` naming the limit."""
    budget = max_smem - fixed_smem
    qpb = min(32, budget // (8 * k))
    if qpb < 1:
        raise ValueError(
            f"k={k} is above the streaming top-k kernel's limit of "
            f"{budget // 8} for these rows: one query's running list must "
            f"fit a block's shared memory")
    smem = fixed_smem + 8 * qpb * k
    per_sm = max(1, min(2, SM_SMEM // (smem + 1024)))
    q_tiles = -(-b // qpb)
    n_tiles = -(-n // STREAM_TILE)
    slices = max(1, min(n_tiles, sms * per_sm // q_tiles))
    tiles_per_slice = -(-n_tiles // slices)
    return qpb, -(-n_tiles // tiles_per_slice), tiles_per_slice


def mips_topk_stream_plain(queries: torch.Tensor, embeddings: torch.Tensor,
                           k: int):
    """Plain PyTorch version of kernel B9: the f32 product of the f32 query
    with the rows cast to f32 (TF32 off on the card), 16,384 rows at a
    time, carried in a running ``torch.topk`` -> the exact top-k, sorted
    descending, with distinct ids (the exact oracle's scan)."""
    n = embeddings.shape[0]
    return _scan_cols(
        queries, lambda s, w: embeddings[s:s + w].to(torch.float32).T, n,
        min(k, n), 16384, n)


def _check_stream_args(q, emb):
    if not q.is_floating_point():
        raise TypeError(f"queries must be floating point, got {q.dtype}")
    if emb.dtype not in STREAM_DTYPES:
        raise TypeError(f"rows must be one of {STREAM_DTYPES}, got "
                        f"{emb.dtype}")
    if q.device != emb.device:
        raise ValueError(f"queries on {q.device}, rows on {emb.device}")
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shape mismatch: queries {tuple(q.shape)}, rows "
                         f"{tuple(emb.shape)}")
    if not emb.is_contiguous():
        raise ValueError("rows must be contiguous")


def mips_topk_stream(queries: torch.Tensor, embeddings: torch.Tensor,
                     k: int):
    """Exact fused MIPS top-k (counterpart of ``mips_topk_pallas``):
    queries (B, d), ``embeddings`` (N, d) bf16 or f32 -> (scores (B, k)
    f32, ids (B, k) int32), sorted descending, k = min(k, N), distinct ids.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/mips_stream.cu`` (kernel B9, counted in
    ``mips_topk_stream.launches``) or raise — there is no fallback. The
    query is f32; for bf16 rows it goes in as its (hi, lo) bf16 split, so a
    bf16 query scores exactly bf16 x bf16."""
    n = embeddings.shape[0]
    k = min(k, n)
    _check_stream_args(queries, embeddings)
    if embeddings.device.type == "cpu":
        return mips_topk_stream_plain(queries, embeddings, k)
    if embeddings.device.type != "cuda":
        raise ValueError(f"unsupported device {embeddings.device}")
    q = queries.to(torch.float32).contiguous()
    b, d = q.shape
    if embeddings.dtype == torch.bfloat16:
        qh, ql = split_hilo_bf16(q)
        planes = (qh, ql)
    else:
        planes = (q,)
    if d % 16 or any(t.data_ptr() % 16 for t in (*planes, embeddings)):
        raise ValueError("kernel needs d % 16 == 0 and 16-byte aligned "
                         "queries and rows")
    if n >= 2 ** 31 - STREAM_TILE:
        raise ValueError(f"kernel row count out of range: {n}")
    dev = embeddings.device
    qpb, slices, tiles_per_slice = stream_geometry(
        b, n, k, *stream_smem(embeddings.dtype),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    out_s = torch.empty((slices, b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((slices, b, k), dtype=torch.int32, device=dev)
    lib = _kernel_libs()["mips_stream"]
    fn = (lib.mips_stream_bf16_launch if len(planes) == 2
          else lib.mips_stream_f32_launch)
    with torch.cuda.device(dev):
        rc = fn(*(t.data_ptr() for t in planes), embeddings.data_ptr(), b, d,
                n, k, qpb, tiles_per_slice, out_s.data_ptr(),
                out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mips_stream launch failed: cudaError {rc}")
    mips_topk_stream.launches += 1
    return _merge_candidates(out_s.permute(1, 0, 2).reshape(b, -1),
                             out_i.permute(1, 0, 2).reshape(b, -1), k, b)


mips_topk_stream.launches = 0
