"""Exact fused MIPS top-k: the streaming kernel B9 and its plain version.

Counterpart of ``jsa_rag_tpu/ops/mips_pallas.py``: ``mips_topk_pallas``
(:93-161) and its Pallas kernel ``_mips_kernel`` (:38-90), which carries a
sorted running top-k across the N tiles in VMEM. Here the CUDA kernel
``csrc/mips_stream.cu`` splits the rows into slices, keeps an exact running
top-k of each slice per query in its own rows of the (S, B, k) output, and
the wrapper merges the slices' candidates exactly
(``mips_topt._merge_candidates``); the source explains the design and why
it is exact.
"""

from __future__ import annotations

import torch

from .mips_topt import (_kernel_libs, _merge_candidates, _scan_cols,
                        bf16_query_planes, dense_query)

STREAM_DTYPES = (torch.bfloat16, torch.float32)
STREAM_TILE = 256  # index rows a block scores at a time
STREAM_K_MAX = 32768  # the lists live in device memory; K_MAX in the source
SM_SMEM = 233_472  # an SM's shared memory; each resident block reserves 1 KB

# csrc/mips_stream.cu's shared-memory layout (stream_layout), mirrored (the
# card tests compare with mips_stream_smem): bf16 rows take 1 KB of
# barriers, a 1 KB row buffer for each of 8 warps, 12 bytes for each of 128
# queries and 1 KB of alignment slack, then wgmma_scan.cuh's ring of stages
# of (16 KB a query plane + 32 KB of index rows), at most 8; the scores of
# the lists of k slots of min(b, 128) queries go beside where a ring of two
# stages still fits, else they live in the output (the ids always do); f32 rows take the f32 core's stages
# (dense_scan.cuh::SmemF32<256>) and 12 bytes for each of 32 queries.
_F32_STAGE = max((32 * 257 + 32 * 33) * 4, 32 * 264 * 4)
_MAX_SMEM = 232_448  # a block's shared memory on sm_90
_STREAM_FIXED = 1024 + 8 * 256 * 4 + 3 * 128 * 4 + 1024


def stream_smem(dtype: torch.dtype, planes: int = 1, k: int = 1,
                b: int = 128) -> int:
    """The shared memory a block of kernel B9 takes for ``dtype`` rows,
    ``planes`` bf16 query planes, ``k`` and a batch of ``b`` queries (a
    pure function of its arguments)."""
    if dtype == torch.float32:
        return _F32_STAGE + 3 * 32 * 4
    stride = planes * 128 * 128 + 256 * 128
    lists = 4 * min(b, 128) * k
    avail = _MAX_SMEM - _STREAM_FIXED - lists
    if avail >= 2 * stride:
        return _STREAM_FIXED + min(8, avail // stride) * stride + lists
    return _STREAM_FIXED + min(8, (_MAX_SMEM - _STREAM_FIXED) // stride) \
        * stride


def stream_rows(b: int, device) -> torch.Tensor:
    """Kernel B9's query order: within each tile of 128 the caller's query
    i sits at position 16 * (i % 8) + i // 8, so consecutive queries fall
    on different warps (a warp merges its own 16 rows), -> (ceil(b / 128) *
    128,) int32, the caller's row at each position, -1 for padding."""
    pos = torch.arange(-(-b // 128) * 128, device=device, dtype=torch.int32)
    p = pos % 128
    row = pos - p + 8 * (p % 16) + p // 16
    return torch.where(row < b, row, -1)


def stream_qpb(dtype: torch.dtype) -> int:
    """Queries a block of kernel B9 takes: the 16-bit core's 128 (two
    warpgroups of 64) for bf16 rows, the f32 core's 32 for f32 rows."""
    return 32 if dtype == torch.float32 else 128


def stream_geometry(b: int, n: int, k: int, qpb: int, smem: int, sms: int):
    """How kernel B9 cuts its work -> (queries a block, slices, tiles a
    slice): blocks of ``qpb`` queries, and the N tiles cut into as many
    slices as fill the ``sms`` SMs once at the blocks an SM that ``smem``
    bytes a block allow (at most two). A k above ``STREAM_K_MAX`` raises
    ``ValueError`` naming the limit."""
    if k > STREAM_K_MAX:
        raise ValueError(
            f"k={k} is above the streaming top-k kernel's limit of "
            f"{STREAM_K_MAX}")
    # a 16-bit block (qpb 128) holds 288 threads of 168 registers: one an SM
    per_sm = 1 if qpb > 32 else max(1, min(2, SM_SMEM // (smem + 1024)))
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
    ``mips_topk_stream.launches``) or raise — there is no fallback. For bf16
    rows the query goes in as ``bf16_query_planes``: a bf16 query is one
    plane and scores exactly bf16 x bf16, an f32 one its (hi, lo) split;
    for f32 rows it is f32."""
    n = embeddings.shape[0]
    k = min(k, n)
    _check_stream_args(queries, embeddings)
    if embeddings.device.type == "cpu":
        return mips_topk_stream_plain(queries, embeddings, k)
    if embeddings.device.type != "cuda":
        raise ValueError(f"unsupported device {embeddings.device}")
    if embeddings.dtype == torch.bfloat16:
        planes = bf16_query_planes(dense_query(queries, embeddings))
    else:
        planes = (queries.to(torch.float32).contiguous(),)
    b, d = queries.shape
    if d % 16 or any(t.data_ptr() % 16 for t in (*planes, embeddings)):
        raise ValueError("kernel needs d % 16 == 0 and 16-byte aligned "
                         "queries and rows")
    if n >= 2 ** 31 - STREAM_TILE:
        raise ValueError(f"kernel row count out of range: {n}")
    dev = embeddings.device
    qpb, slices, tiles_per_slice = stream_geometry(
        b, n, k, stream_qpb(embeddings.dtype),
        stream_smem(embeddings.dtype, len(planes), k, b),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    out_s = torch.empty((slices, b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((slices, b, k), dtype=torch.int32, device=dev)
    lib = _kernel_libs()["mips_stream"]
    if embeddings.dtype == torch.bfloat16:
        src = stream_rows(b, dev)
        keep = (src >= 0)[:, None]
        planes = [torch.where(keep, p.index_select(0, src.clamp(min=0)), 0)
                  for p in planes]
        # a null lo plane selects the one-plane instance
        fn = lib.mips_stream_bf16_launch
        ptrs = (planes[0].data_ptr(),
                planes[1].data_ptr() if len(planes) == 2 else None,
                src.data_ptr())
    else:
        fn, ptrs = lib.mips_stream_f32_launch, (planes[0].data_ptr(),)
    with torch.cuda.device(dev):
        rc = fn(*ptrs, embeddings.data_ptr(), b, d,
                n, k, qpb, tiles_per_slice, out_s.data_ptr(),
                out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mips_stream launch failed: cudaError {rc}")
    mips_topk_stream.launches += 1
    return _merge_candidates(out_s.permute(1, 0, 2).reshape(b, -1),
                             out_i.permute(1, 0, 2).reshape(b, -1), k, b)


mips_topk_stream.launches = 0
