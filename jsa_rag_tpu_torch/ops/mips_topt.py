"""int8r coarse scan + exact candidate merge + rows refine.

Counterpart of ``jsa_rag_tpu/ops/mips_pallas2.py``, int8r subset: the
``refine > 0``, ``res_rows``, ``int8r_refine="rows"`` branch of
``mips_topk_pallas2_int8_t`` (:794-945) — the default search of the int8r
flat index. The Pallas kernel ``_topt_int8r2_kernel_t`` (:724-747, with its
``_emit_topt`` epilogue, :32-49) becomes the hand-written CUDA kernel
``csrc/topt_int8r2.cu``; its plain PyTorch version lives here
(``scan_topt_int8r2_plain``). Quantisation, the merge and the refine stay
plain PyTorch, as they stayed XLA in the JAX package.

Layout: the index plane is row-major ``(N, d)`` here (the JAX package keeps
``(d, N)`` for the TPU's MXU); see the kernel source for why.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import exact_f32_matmul
from ._build import load_library

NEG_INF = float(torch.finfo(torch.float32).min)
KERNEL_TILES = (128, 256)  # emit tiles the CUDA kernel is built for
_INV_127 = float(np.float32(1.0 / 127.0))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pool_t(k: int, n: int, tile_n: int, t_per_tile: int) -> int:
    """Per-tile candidate-pool depth T (``mips_pallas2.py::_pool_t``).

    ``n`` is the count of VALID rows and tiles are counted by floor, so a
    trailing mostly-padded tile cannot starve the pool (regression: n=4099,
    k=100). Mean per-tile share k/full plus a 3-sigma binomial margin."""
    full_tiles = max(1, n // tile_n)
    margin = int(3 * (k / full_tiles) ** 0.5 + 1)
    return min(tile_n, max(t_per_tile, -(-k // full_tiles) + margin))


# ---------------------------------------------------------------- quantise
def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x ~= v * scale, scale (rows, 1) f32.
    Round half to even, clip to +-127, amax floored at 1e-12. The scale is
    amax times f32(1/127), which is what XLA compiles the JAX package's
    ``amax / 127.0`` into, so both packages store the same scales."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) * _INV_127
    v = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return v, scale


def quantize_int8_residual(x: torch.Tensor):
    """Two-plane residual quantisation x ~= v1*s1 + v2*s2, per-row scales
    (plane 2 quantises plane 1's rounding error).
    -> (v1 (rows, d) int8, s1 (rows, 1) f32, v2 (rows, d) int8,
        s2 (rows, 1) f32).

    The residual x - v1*s1 is formed exactly and rounded once (in f64,
    where the int8 x f32 product and the near-cancelling difference are
    exact), as the fused multiply-add of the JAX package's compiled
    program rounds it."""
    x = x.to(torch.float32)
    v1, s1 = quantize_int8(x)
    r = (x.to(torch.float64) - v1.to(torch.float64) * s1.to(torch.float64))
    v2, s2 = quantize_int8(r.to(torch.float32))
    return v1, s1, v2, s2


# ------------------------------------------------------------ scan + emit
def _check_scan_args(qv1, qs1, qv2, qs2, emb, es, valid_n, tile_n,
                     t_per_tile):
    b, d = qv1.shape
    n_rows = emb.shape[0]
    for name, t, dtype, numel in (
            ("qv1", qv1, torch.int8, b * d), ("qv2", qv2, torch.int8, b * d),
            ("qs1", qs1, torch.float32, b), ("qs2", qs2, torch.float32, b),
            ("emb", emb, torch.int8, n_rows * d),
            ("es", es, torch.float32, n_rows)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != emb.device:
            raise ValueError(f"{name} is on {t.device}, emb on {emb.device}")
        if t.numel() != numel:
            raise ValueError(f"{name} has {t.numel()} elements, want {numel}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qv2.shape != (b, d) or emb.dim() != 2 or emb.shape[1] != d:
        raise ValueError(f"shape mismatch: qv {tuple(qv1.shape)}, "
                         f"qv2 {tuple(qv2.shape)}, emb {tuple(emb.shape)}")
    if not 0 <= valid_n <= n_rows:
        raise ValueError(f"valid_n {valid_n} outside [0, {n_rows}]")
    if not 1 <= t_per_tile <= tile_n:
        raise ValueError(f"t_per_tile {t_per_tile} outside [1, {tile_n}]")


def scan_topt_int8r2_plain(qv1, qs1, qv2, qs2, emb, es, valid_n: int,
                           tile_n: int, t_per_tile: int):
    """Plain PyTorch version of the kernel: the same scores, the same
    (score desc, column asc) order per tile, the same -1 sentinel.

    The int8 products run as a float matmul, which is exact: every partial
    sum is an integer of magnitude <= d*127^2, exactly representable in f32
    while that is < 2^24 (d <= 1040) and in f64 beyond. A stable descending
    sort of each tile orders equal scores by column, which is what T
    first-occurrence extract-max passes emit. Scans ~64k index rows at a
    time so the (B, N) score matrix never exists whole."""
    _check_scan_args(qv1, qs1, qv2, qs2, emb, es, valid_n, tile_n,
                     t_per_tile)
    b, d = qv1.shape
    n_rows = emb.shape[0]
    n_tiles = -(-n_rows // tile_n)
    exact = torch.float32 if d * 127 * 127 < 2 ** 24 else torch.float64
    dev = emb.device
    qs1, qs2, es = qs1.reshape(b, 1), qs2.reshape(b, 1), es.reshape(-1)
    q = torch.cat([qv1, qv2]).to(exact)
    out_s = torch.empty((n_tiles, b, t_per_tile), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_tiles, b, t_per_tile), dtype=torch.int32,
                        device=dev)
    step = max(1, 65536 // tile_n)
    for c0 in range(0, n_tiles, step):
        c1 = min(n_tiles, c0 + step)
        lo, hi = c0 * tile_n, min(c1 * tile_n, n_rows)
        acc = (q @ emb[lo:hi].to(exact).T).to(torch.float32)
        s = (acc[:b] * qs1 + acc[b:] * qs2) * es[lo:hi]
        col = torch.arange(lo, hi, device=dev)
        s = torch.where(col < valid_n, s, NEG_INF)
        width = (c1 - c0) * tile_n
        if hi - lo < width:  # ragged last tile: absent rows are masked
            s = torch.nn.functional.pad(s, (0, width - (hi - lo)),
                                        value=NEG_INF)
        s = s.reshape(b, c1 - c0, tile_n)
        v, order = torch.sort(s, dim=-1, descending=True, stable=True)
        v, order = v[..., :t_per_tile], order[..., :t_per_tile]
        base = (torch.arange(c0, c1, device=dev) * tile_n).view(1, -1, 1)
        ids = torch.where(v > NEG_INF * 0.5, order + base, -1)
        out_s[c0:c1] = v.permute(1, 0, 2)
        out_i[c0:c1] = ids.permute(1, 0, 2).to(torch.int32)
    return out_s, out_i


@functools.cache
def _kernel_lib():
    lib = load_library("topt_int8r2")
    # pointers and the stream as c_void_p: undeclared, ctypes would pass
    # them as 32-bit ints and cut them
    lib.topt_int8r2_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
    lib.topt_int8r2_launch.restype = ctypes.c_int
    return lib


def scan_topt_int8r2(qv1, qs1, qv2, qs2, emb, es, valid_n: int,
                     tile_n: int, t_per_tile: int):
    """Two-plane int8 scan + per-tile top-T emit -> (scores, ids), each
    (ceil(N / tile_n), B, T).

    qv1, qv2 (B, d) int8 and qs1, qs2 (B, 1) f32: the query planes;
    emb (N, d) int8 and es (1, N) f32: index plane 1 and its scales;
    columns at or past ``valid_n`` score NEG_INF. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/topt_int8r2.cu`` (and count it in
    ``scan_topt_int8r2.launches``) or raise — there is no fallback."""
    if emb.device.type == "cpu":
        return scan_topt_int8r2_plain(qv1, qs1, qv2, qs2, emb, es, valid_n,
                                      tile_n, t_per_tile)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_scan_args(qv1, qs1, qv2, qs2, emb, es, valid_n, tile_n,
                     t_per_tile)
    b, d = qv1.shape
    n_rows = emb.shape[0]
    n_tiles = -(-n_rows // tile_n)
    if tile_n not in KERNEL_TILES:
        raise ValueError(f"kernel tile_n must be one of {KERNEL_TILES}")
    if d % 16 or any(t.data_ptr() % 16 for t in (qv1, qv2, emb)):
        raise ValueError("kernel needs d % 16 == 0 and 16-byte aligned "
                         "int8 planes")
    # one block per (32-query tile, index tile) on a 1-D grid; row ids and
    # the grid are int32
    if (b < 1 or n_tiles < 1 or n_rows >= 2 ** 31 - tile_n
            or -(-b // 32) * n_tiles >= 2 ** 31):
        raise ValueError(f"kernel grid out of range: b={b}, "
                         f"n_tiles={n_tiles}")
    out_s = torch.empty((n_tiles, b, t_per_tile), dtype=torch.float32,
                        device=emb.device)
    out_i = torch.empty((n_tiles, b, t_per_tile), dtype=torch.int32,
                        device=emb.device)
    lib = _kernel_lib()
    with torch.cuda.device(emb.device):
        rc = lib.topt_int8r2_launch(
            qv1.data_ptr(), qs1.data_ptr(), qv2.data_ptr(), qs2.data_ptr(),
            emb.data_ptr(), es.data_ptr(), b, d, n_rows, int(valid_n),
            tile_n, t_per_tile, out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(emb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"topt_int8r2 launch failed: cudaError {rc}")
    scan_topt_int8r2.launches += 1
    return out_s, out_i


scan_topt_int8r2.launches = 0


# ------------------------------------------------------- merge and refine
def _merge_candidates(cand_s, cand_i, k: int, b: int):
    """Exact top-k of the (B, W) candidate lists."""
    k_eff = min(k, cand_s.shape[1])
    v, a = torch.topk(cand_s, k_eff, dim=1)
    return v[:b], torch.gather(cand_i, 1, a)[:b]


def _int8r_rows_refine(q, coarse_vals, res_rows, res_scale, ids, k: int,
                       nv: int):
    """Full-precision score = coarse (exact plane-1 term q.(v1*s1)) +
    q.(v2*s2), plane 2 gathered as contiguous rows; placeholder ids (-1)
    clip-gather row 0 and are masked, as are ids at or past ``nv``."""
    if q.device.type == "cuda":
        exact_f32_matmul()
    n = res_rows.shape[0]
    flat = ids.long().clamp(0, n - 1)
    x2 = res_rows[flat].to(torch.float32)
    s2 = res_scale.reshape(-1)[flat].unsqueeze(-1)
    s = coarse_vals + torch.einsum("bd,bkd->bk", q, x2 * s2)
    s = torch.where((ids >= 0) & (ids < nv), s, NEG_INF)
    v, a = torch.topk(s, k, dim=1)
    return v, torch.gather(ids, 1, a)


def mips_topk_int8r_t(
    queries: torch.Tensor,    # (B, d) f32
    emb_rows: torch.Tensor,   # (N, d) int8, plane 1
    emb_scale: torch.Tensor,  # (1, N) f32, plane-1 row scales
    k: int,
    *,
    res_rows: torch.Tensor,   # (N, d) int8, plane 2
    res_scale: torch.Tensor,  # (1, N) f32, plane-2 row scales
    valid_n: int | None = None,
    pool_n: int | None = None,
    tile_n: int = 256,
    t_per_tile: int = 4,
    refine: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual-int8 MIPS: two-plane query scan selects the top-(refine*k)
    by the exact plane-1 score, the rows refine adds the plane-2 term, the
    final top-k comes back as (scores (B, k) f32, ids (B, k) int32).

    ``valid_n`` masks index rows at or past it (runtime count); ``pool_n``
    is a lower bound on valid rows for the per-tile pool depth, as in the
    JAX wrapper. ``tile_n`` is the emit tile: 256 here against the TPU's
    2048 (a tile of scores has to fit one block's shared memory); it is
    clamped to ``round_up(N, 128)`` like the JAX wrapper clamps its own."""
    if refine < 1:
        raise ValueError("the int8r path needs refine >= 1")
    b, d = queries.shape
    n = emb_rows.shape[0]
    k = min(k, n)
    k_sel = min(refine * k, n)
    valid_n = n if valid_n is None else int(valid_n)
    tile_n = min(tile_n, _round_up(n, 128))
    t = _pool_t(k_sel, min(n, pool_n if pool_n is not None else n),
                tile_n, t_per_tile)
    q = queries.to(torch.float32)
    qv1, qs1, qv2, qs2 = quantize_int8_residual(q)
    cand_s, cand_i = scan_topt_int8r2(qv1, qs1, qv2, qs2, emb_rows,
                                      emb_scale, valid_n, tile_n, t)
    cand_s = cand_s.permute(1, 0, 2).reshape(b, -1)
    cand_i = cand_i.permute(1, 0, 2).reshape(b, -1)
    vals, ids = _merge_candidates(cand_s, cand_i, k_sel, b)
    return _int8r_rows_refine(q, vals, res_rows, res_scale, ids, k, valid_n)
