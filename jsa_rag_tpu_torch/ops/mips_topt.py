"""Scan-and-select MIPS: the int8 (one- and two-plane query), dense
(bf16/f32) and fp16 scans, the exact candidate merge and the refines.

Counterpart of ``jsa_rag_tpu/ops/mips_pallas2.py``, four subsets:

- int8r: the ``refine > 0``, ``res_rows``, ``int8r_refine="rows"`` branch of
  ``mips_topk_pallas2_int8_t`` (:794-945) — the default search of the int8r
  flat index. The Pallas kernel ``_topt_int8r2_kernel_t`` (:724-747) becomes
  the hand-written CUDA kernel ``csrc/topt_int8r2.cu`` (kernel B1); its plain
  PyTorch version is ``scan_topt_int8r2_plain``;
- int8: every other branch of that wrapper, as ``mips_topk_int8_t`` — int8
  storage (refine 0), the hybrid index (int8 coarse scan, then
  ``_f16_refine`` over its fp16 rows) and the int8r ``rows1``/``cols``
  refines. The Pallas kernel ``_topt_int8_kernel_t`` (:769-786) becomes the
  single-plane instance of the same CUDA template (kernel B2,
  ``scan_topt_int8``); its plain version is ``scan_topt_int8_plain``;
- dense: ``mips_topk_pallas2_t`` (:203-292), the search of every bf16/f32
  flat index, as ``mips_topk_dense_t``. The Pallas kernel ``_topt_kernel_t``
  (:176-200) becomes ``csrc/topt_dense.cu`` (kernel B3); its plain version
  is ``scan_topt_dense_plain``;
- fp16: ``mips_topk_pallas2_f16_t`` (:500-613), the search of every float16
  flat index, as ``mips_topk_f16_t``. Its Pallas kernels ``_topt_f16h_kernel_t``
  (:446-465, the coarse pass of ``refine > 0``) and ``_topt_f16_kernel_t``
  (:468-492, fp16-exact scores for ``refine = 0``) become the fp16 instances
  of the 16-bit template in ``csrc/topt_dense.cu`` (kernels B4 and B5); their
  plain versions are ``scan_topt_f16h_plain`` and ``scan_topt_f16_plain``.

The row-major wrappers ``mips_topk_pallas2`` (:91-160),
``mips_topk_pallas2_f16`` (:350-425) and ``mips_topk_pallas2_int8``
(:948-1028), behind ``ops/mips.py::mips_topk`` and the benches, become
``mips_topk_dense`` (kernel B6), ``mips_topk_f16`` (B7) and
``mips_topk_int8`` (B8): in the port's row-major layout their Pallas
kernels compute the functions of B3, B5 and B2 with every row valid, so
they launch those instances; each launch is counted where it happens, once,
under the wrapper's name (``_launch``'s ``counter``).

Every kernel ends in the per-tile emit ``_emit_topt`` (:32-49), shared in
``csrc/topt_emit.cuh``. Quantisation, the merge and the refine stay plain
PyTorch, as they stayed XLA in the JAX package.

Layout: the index is row-major ``(N, d)`` here (the JAX package keeps
``(d, N)`` for the TPU's MXU); see the kernel sources for why.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..device import exact_f32_matmul
from ..utils import trace
from ._build import load_libraries

NEG_INF = float(torch.finfo(torch.float32).min)
KERNEL_TILES = (128, 256)  # emit tiles the CUDA kernels are built for
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


def scan_geometry(n: int, k: int, pool_n: int | None = None,
                  tile_n: int = 256, t_per_tile: int = 4) -> tuple[int, int]:
    """(emit tile, T) a fused search over ``n`` index rows gives its scan
    when it selects ``k`` candidates: the tile clamps to ``round_up(n,
    128)`` and T comes from ``_pool_t`` over ``pool_n`` (a lower bound on
    the valid rows; ``n`` when None)."""
    tile_n = min(tile_n, _round_up(n, 128))
    return tile_n, _pool_t(k, min(n, n if pool_n is None else pool_n),
                           tile_n, t_per_tile)


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


# ------------------------------------------------------ exact top-k
def _scan_cols(queries, cols, n: int, k: int, chunk: int, valid_n: int):
    """Exact top-k by a running ``torch.topk``: ``cols(start, width)`` ->
    the (d, width) f32 chunk of the index, columns at or past ``valid_n``
    masked; f32 products with TF32 off on the card. The oracle of
    ``ops/mips.py`` and kernel B9's plain version."""
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
    # equal scores in ascending id order, as lax.top_k returns them
    # (torch.topk leaves their order open)
    ci, a = torch.sort(ci, dim=1)
    cs, a2 = torch.sort(torch.gather(cs, 1, a), dim=1, descending=True,
                        stable=True)
    return cs, torch.gather(ci, 1, a2)


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


def _tile_topt_plain(score_rows, b: int, n_rows: int, valid_n: int,
                     tile_n: int, t_per_tile: int, dev):
    """Per-tile top-T of the scores ``score_rows(lo, hi)`` -> (B, hi - lo)
    f32, over ~64k index rows at a time so the (B, N) score matrix never
    exists whole. A stable descending sort of each tile orders equal scores
    by column, which is what T first-occurrence extract-max passes emit;
    columns at or past ``valid_n`` score NEG_INF and exhausted slots get
    id -1."""
    n_tiles = -(-n_rows // tile_n)
    out_s = torch.empty((n_tiles, b, t_per_tile), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_tiles, b, t_per_tile), dtype=torch.int32,
                        device=dev)
    step = max(1, 65536 // tile_n)
    for c0 in range(0, n_tiles, step):
        c1 = min(n_tiles, c0 + step)
        lo, hi = c0 * tile_n, min(c1 * tile_n, n_rows)
        s = score_rows(lo, hi)
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


def scan_topt_int8r2_plain(qv1, qs1, qv2, qs2, emb, es, valid_n: int,
                           tile_n: int, t_per_tile: int):
    """Plain PyTorch version of kernel B1: the same scores, the same
    (score desc, column asc) order per tile, the same -1 sentinel.

    The int8 products run as a float matmul, which is exact: every partial
    sum is an integer of magnitude <= d*127^2, exactly representable in f32
    while that is < 2^24 (d <= 1040) and in f64 beyond."""
    _check_scan_args(qv1, qs1, qv2, qs2, emb, es, valid_n, tile_n,
                     t_per_tile)
    b, d = qv1.shape
    exact = torch.float32 if d * 127 * 127 < 2 ** 24 else torch.float64
    qs1, qs2, es = qs1.reshape(b, 1), qs2.reshape(b, 1), es.reshape(-1)
    q = torch.cat([qv1, qv2]).to(exact)

    def score_rows(lo, hi):
        acc = (q @ emb[lo:hi].to(exact).T).to(torch.float32)
        return (acc[:b] * qs1 + acc[b:] * qs2) * es[lo:hi]

    return _tile_topt_plain(score_rows, b, emb.shape[0], valid_n, tile_n,
                            t_per_tile, emb.device)


def _check_int8_args(qv, qs, emb, es, valid_n, tile_n, t_per_tile):
    b, d = qv.shape
    n_rows = emb.shape[0]
    for name, t, dtype, numel in (
            ("qv", qv, torch.int8, b * d), ("qs", qs, torch.float32, b),
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
    if emb.dim() != 2 or emb.shape[1] != d:
        raise ValueError(f"shape mismatch: qv {tuple(qv.shape)}, "
                         f"emb {tuple(emb.shape)}")
    if not 0 <= valid_n <= n_rows:
        raise ValueError(f"valid_n {valid_n} outside [0, {n_rows}]")
    if not 1 <= t_per_tile <= tile_n:
        raise ValueError(f"t_per_tile {t_per_tile} outside [1, {tile_n}]")


def scan_topt_int8_plain(qv, qs, emb, es, valid_n: int, tile_n: int,
                         t_per_tile: int):
    """Plain PyTorch version of kernel B2: scores ``(acc * qs) * es`` in
    that order (the JAX kernel's and the CUDA kernel's), the valid-count
    mask and the per-tile top-T of ``_tile_topt_plain``. The int8 products
    are exact as in ``scan_topt_int8r2_plain``."""
    _check_int8_args(qv, qs, emb, es, valid_n, tile_n, t_per_tile)
    b, d = qv.shape
    exact = torch.float32 if d * 127 * 127 < 2 ** 24 else torch.float64
    qs, es = qs.reshape(b, 1), es.reshape(-1)
    q = qv.to(exact)

    def score_rows(lo, hi):
        acc = (q @ emb[lo:hi].to(exact).T).to(torch.float32)
        return acc * qs * es[lo:hi]

    return _tile_topt_plain(score_rows, b, emb.shape[0], valid_n, tile_n,
                            t_per_tile, emb.device)


KERNELS = ("topt_int8r2", "topt_dense", "mips_stream")


@functools.cache
def _kernel_libs() -> dict:
    """Every kernel source, built together (one nvcc each, concurrently) at
    first use: ``topt_int8r2`` holds B1 and B2 (B8), ``topt_dense`` B3, B4
    and B5 (B6, B7), ``mips_stream`` B9 (``ops/mips_stream.py``)."""
    libs = load_libraries(KERNELS)
    # pointers and the stream as c_void_p: undeclared, ctypes would pass
    # them as 32-bit ints and cut them
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
            (libs["topt_int8r2"].topt_int8r2_launch,
             [ptr] * 5 + [i32] * 6 + [ptr] * 3),
            (libs["topt_int8r2"].topt_int8_launch,
             [ptr] * 4 + [i32] * 6 + [ptr] * 3),
            (libs["topt_int8r2"].topt_int8_geometry, [i32] * 4 + [ptr]),
            (libs["topt_dense"].topt_dense_bf16_launch,
             [ptr] * 3 + [i32] * 6 + [ptr] * 3),
            (libs["topt_dense"].topt_dense_f32_launch,
             [ptr] * 2 + [i32] * 6 + [ptr] * 3),
            (libs["topt_dense"].topt_f16h_launch,
             [ptr] * 3 + [i32] * 6 + [ptr] * 3),
            (libs["topt_dense"].topt_f16_launch,
             [ptr] * 4 + [i32] * 6 + [ptr] * 3),
            (libs["mips_stream"].mips_stream_bf16_launch,
             [ptr] * 4 + [i32] * 6 + [ptr] * 3),
            (libs["mips_stream"].mips_stream_f32_launch,
             [ptr] * 2 + [i32] * 6 + [ptr] * 3),
            (libs["mips_stream"].mips_stream_smem, [i32] * 4),
            (libs["mips_stream"].mips_stream_qpb, [i32]),
            (libs["mips_stream"].mips_stream_k_max, [])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return libs


def _check_launch(b: int, d: int, n_rows: int, tile_n: int, planes, *,
                  grid32: bool = False):
    """What every kernel refuses: an emit tile they are not built for, d not
    a multiple of 16 (TMA's 16-byte row stride at any element width), planes
    (and the int8 row scales) not 16-byte aligned for TMA and the f32 loads,
    an empty batch or index, or a row id past int32; with ``grid32``, a grid
    past int32. -> n_tiles.

    The int8 and 16-bit kernels run persistent blocks, one an SM, over a
    64-bit count of units; only the f32 scan keeps one block per (32-query
    tile, index tile) on a 1-D grid (``grid32``)."""
    if tile_n not in KERNEL_TILES:
        raise ValueError(f"kernel tile_n must be one of {KERNEL_TILES}")
    if d % 16 or any(t.data_ptr() % 16 for t in planes):
        raise ValueError("kernel needs d % 16 == 0 and 16-byte aligned "
                         "planes")
    n_tiles = -(-n_rows // tile_n)
    if (b < 1 or n_tiles < 1 or n_rows >= 2 ** 31 - tile_n
            or (grid32 and -(-b // 32) * n_tiles >= 2 ** 31)):
        raise ValueError(f"kernel grid out of range: b={b}, "
                         f"n_tiles={n_tiles}")
    return n_tiles


def _launch(name: str, fn, args, b: int, n_tiles: int, t_per_tile: int,
            dev, counter):
    """Allocate the (n_tiles, b, T) outputs and launch on the current
    stream; a non-zero cudaError from the launch raises. A clean launch adds
    one to ``counter.launches``: the scan's own count, or that of the
    row-major wrapper that launched the same instance, so each launch lands
    under exactly one name."""
    out_s = torch.empty((n_tiles, b, t_per_tile), dtype=torch.float32,
                        device=dev)
    out_i = torch.empty((n_tiles, b, t_per_tile), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        rc = fn(*args, out_s.data_ptr(), out_i.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    counter.launches += 1
    return out_s, out_i


def interleave_planes(qv1: torch.Tensor, qv2: torch.Tensor) -> torch.Tensor:
    """Kernel B1's A plane: the (B, d) int8 query planes interleaved by
    8-row groups -> (2 * round_up(B, 8), d) int8, rows 16g..16g+7 plane 1
    of queries 8g..8g+7 and rows 16g+8..16g+15 their plane 2, the rows of
    queries past B zero. wgmma's fragment layout then hands each thread
    both planes' sums of one query (``csrc/topt_int8r2.cu``). One stack
    when B % 8 == 0."""
    b, d = qv1.shape
    pad = _round_up(b, 8) - b
    if pad:
        qv1, qv2 = (torch.nn.functional.pad(p, (0, 0, 0, pad))
                    for p in (qv1, qv2))
    return torch.stack([qv1.view(-1, 8, d), qv2.view(-1, 8, d)],
                       dim=1).view(-1, d)


INT8_QROWS = 128  # A rows a unit of the int8 core (wgmma_scan.cuh::CfgS8)
# CfgS8::RING: a block's shared memory less the barriers, the row scales of
# 4 units and the 1024-byte alignment slack
_INT8_RING = 232_448 - 1024 - 4 * 1024 - 1024
_TILE = 256  # index rows a unit
_MAX_STAGES = 8
# csrc/topt_int8r2.cu's schedules, by their number there, which follow the
# query planes: "serial" (B2, one plane) emits a unit after its products;
# "overlap" (B1, two planes) hands each unit's scores to two emit warps
# through a score tile of 64 rows of 260 f32 in shared memory, which takes
# that much from its ring
INT8_SCHEDULES = ("serial", "overlap")
_RINGS = {"serial": _INT8_RING, "overlap": _INT8_RING - 64 * 260 * 4}
_THREADS = {"serial": 256 + 32, "overlap": 256 + 64 + 32}


def int8_scan_geometry(b: int, planes: int, n_rows: int, sms: int) -> dict:
    """How ``csrc/topt_int8r2.cu`` cuts a scan of ``b`` queries with
    ``planes`` query planes (1: B2, 2: B1) over ``n_rows`` rows on ``sms``
    SMs (a pure mirror of its ``geometry``; the card tests compare it with
    ``topt_int8_geometry``): the A plane's rows, the query rows a stage's
    TMA box loads, the tiles of 128 A rows, the ring's stages, the units
    (query tile fastest), the persistent grid, the schedule ("overlap" for
    B1's two planes, "serial" for B2's one) and the block's threads; the
    ring's stages are those of the schedule."""
    a_rows = b if planes == 1 else 2 * _round_up(b, 8)
    qbox = INT8_QROWS if a_rows >= INT8_QROWS else _round_up(a_rows, 8)
    stage = _round_up(qbox * 128, 1024) + _TILE * 128
    q_tiles = -(-a_rows // INT8_QROWS)
    units = q_tiles * -(-n_rows // _TILE)
    schedule = INT8_SCHEDULES[planes - 1]
    return {"a_rows": a_rows, "qbox": qbox, "q_tiles": q_tiles,
            "stages": min(_MAX_STAGES, _RINGS[schedule] // stage),
            "units": units, "grid": min(units, sms), "schedule": schedule,
            "threads": _THREADS[schedule]}


def scan_topt_int8r2(qv1, qs1, qv2, qs2, emb, es, valid_n: int,
                     tile_n: int, t_per_tile: int):
    """Two-plane int8 scan + per-tile top-T emit -> (scores, ids), each
    (ceil(N / tile_n), B, T).

    qv1, qv2 (B, d) int8 and qs1, qs2 (B, 1) f32: the query planes;
    emb (N, d) int8 and es (1, N) f32: index plane 1 and its scales;
    columns at or past ``valid_n`` score NEG_INF. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/topt_int8r2.cu`` (kernel B1, on the
    planes as ``interleave_planes`` lays them out, counted in
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
    qv = interleave_planes(qv1, qv2)
    n_tiles = _check_launch(b, d, n_rows, tile_n, (qv, emb, es))
    return _launch(
        "topt_int8r2", _kernel_libs()["topt_int8r2"].topt_int8r2_launch,
        (qv.data_ptr(), qs1.data_ptr(), qs2.data_ptr(), emb.data_ptr(),
         es.data_ptr(), b, d, n_rows, int(valid_n), tile_n, t_per_tile), b,
        n_tiles, t_per_tile, emb.device, scan_topt_int8r2)


scan_topt_int8r2.launches = 0


def scan_topt_int8(qv, qs, emb, es, valid_n: int, tile_n: int,
                   t_per_tile: int, *, counter=None):
    """Single-plane int8 scan + per-tile top-T emit -> (scores, ids), each
    (ceil(N / tile_n), B, T).

    qv (B, d) int8 and qs (B, 1) f32: the quantised query; emb (N, d) int8
    and es (1, N) f32: the index rows and their scales; rows at or past
    ``valid_n`` score NEG_INF. CPU tensors take the plain version; CUDA
    tensors launch the single-plane instance of ``csrc/topt_int8r2.cu``
    (kernel B2, 128 queries a unit, counted in ``scan_topt_int8.launches``,
    or in ``counter.launches`` when given) or raise — there is no
    fallback."""
    if emb.device.type == "cpu":
        return scan_topt_int8_plain(qv, qs, emb, es, valid_n, tile_n,
                                    t_per_tile)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_int8_args(qv, qs, emb, es, valid_n, tile_n, t_per_tile)
    b, d = qv.shape
    n_rows = emb.shape[0]
    n_tiles = _check_launch(b, d, n_rows, tile_n, (qv, emb, es))
    return _launch(
        "topt_int8", _kernel_libs()["topt_int8r2"].topt_int8_launch,
        (qv.data_ptr(), qs.data_ptr(), emb.data_ptr(), es.data_ptr(), b, d,
         n_rows, int(valid_n), tile_n, t_per_tile), b, n_tiles, t_per_tile,
        emb.device, counter or scan_topt_int8)


scan_topt_int8.launches = 0


# ------------------------------------------------------------- dense scan
DENSE_DTYPES = (torch.bfloat16, torch.float32)


def _check_dense_args(q, emb, valid_n, tile_n, t_per_tile,
                      dtypes=DENSE_DTYPES):
    if q.dtype != torch.float32 and not (q.dtype == emb.dtype
                                         == torch.bfloat16):
        raise TypeError(f"queries must be float32 (or bfloat16 against "
                        f"bfloat16 rows), got {q.dtype}")
    if emb.dtype not in dtypes:
        raise TypeError(f"index rows must be one of {dtypes}, got "
                        f"{emb.dtype}")
    if q.device != emb.device:
        raise ValueError(f"queries on {q.device}, index on {emb.device}")
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shape mismatch: queries {tuple(q.shape)}, index "
                         f"{tuple(emb.shape)}")
    if not (q.is_contiguous() and emb.is_contiguous()):
        raise ValueError("queries and index rows must be contiguous")
    if not 0 <= valid_n <= emb.shape[0]:
        raise ValueError(f"valid_n {valid_n} outside [0, {emb.shape[0]}]")
    if not 1 <= t_per_tile <= tile_n:
        raise ValueError(f"t_per_tile {t_per_tile} outside [1, {tile_n}]")


def split_hilo_bf16(q: torch.Tensor):
    """f32 -> (hi, lo) bf16 with hi + lo == q to ~17 bits: hi = bf16(q),
    lo = bf16(q - hi), both rounded to nearest (the JAX package's
    ``_split_hilo_bf16`` truncates hi by masking, which XLA cannot fold
    away; PyTorch runs the round trip as written)."""
    hi = q.to(torch.bfloat16)
    return hi, (q - hi.to(torch.float32)).to(torch.bfloat16)


def bf16_query_planes(q: torch.Tensor) -> tuple:
    """The bf16 planes a 16-bit kernel scores against bf16 rows, chosen by
    the query's dtype alone (no look at its values, no sync): a bf16 query
    is its own single plane, exact as it is; an f32 query is its (hi, lo)
    split (``split_hilo_bf16``)."""
    if q.dtype == torch.bfloat16:
        return (q,)
    return split_hilo_bf16(q)


def dense_query(queries: torch.Tensor, emb_rows: torch.Tensor):
    """The query a dense wrapper hands its scan: a bf16 query against bf16
    rows stays bf16 (one plane on the card), any other is widened to f32."""
    if queries.dtype == emb_rows.dtype == torch.bfloat16:
        return queries.contiguous()
    return queries.to(torch.float32).contiguous()


def scan_topt_dense_plain(q, emb, valid_n: int, tile_n: int,
                          t_per_tile: int):
    """Plain PyTorch version of kernel B3: an f32 matmul of the query (a
    bf16 one widened exactly) against the rows cast to f32 (TF32 off on the
    card), the valid-count mask and the per-tile top-T of
    ``_tile_topt_plain``."""
    _check_dense_args(q, emb, valid_n, tile_n, t_per_tile)
    if q.device.type == "cuda":
        exact_f32_matmul()
    q = q.to(torch.float32)

    def score_rows(lo, hi):
        return q @ emb[lo:hi].to(torch.float32).T

    return _tile_topt_plain(score_rows, q.shape[0], emb.shape[0], valid_n,
                            tile_n, t_per_tile, emb.device)


def scan_topt_dense(q, emb, valid_n: int, tile_n: int, t_per_tile: int, *,
                    counter=None):
    """Dense scan + per-tile top-T emit -> (scores, ids), each
    (ceil(N / tile_n), B, T).

    q (B, d) f32, or bf16 against bf16 rows; emb (N, d) bf16 or f32 rows;
    columns at or past ``valid_n`` score NEG_INF. CPU tensors take the
    plain version; CUDA tensors launch ``csrc/topt_dense.cu`` (and count it
    in ``scan_topt_dense.launches``, or in ``counter.launches`` when given)
    or raise — there is no fallback. For bf16 rows the query goes in as
    ``bf16_query_planes``: one plane for a bf16 query, the (hi, lo) split
    of an f32 one."""
    if emb.device.type == "cpu":
        return scan_topt_dense_plain(q, emb, valid_n, tile_n, t_per_tile)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_dense_args(q, emb, valid_n, tile_n, t_per_tile)
    b, d = q.shape
    n_rows = emb.shape[0]
    lib = _kernel_libs()["topt_dense"]
    if emb.dtype == torch.bfloat16:
        planes = bf16_query_planes(q)
        n_tiles = _check_launch(b, d, n_rows, tile_n, (*planes, emb))
        # a null lo plane selects the one-plane instance
        fn = lib.topt_dense_bf16_launch
        ptrs = (planes[0].data_ptr(),
                planes[1].data_ptr() if len(planes) == 2 else None)
    else:
        n_tiles = _check_launch(b, d, n_rows, tile_n, (q, emb), grid32=True)
        fn, ptrs = lib.topt_dense_f32_launch, (q.data_ptr(),)
    return _launch("topt_dense", fn,
                   (*ptrs, emb.data_ptr(), b, d, n_rows, int(valid_n), tile_n,
                    t_per_tile), b, n_tiles, t_per_tile, emb.device,
                   counter or scan_topt_dense)


scan_topt_dense.launches = 0


def mips_topk_dense_t(
    queries: torch.Tensor,   # (B, d)
    emb_rows: torch.Tensor,  # (N, d) bf16 or f32
    k: int,
    *,
    valid_n: int | None = None,
    pool_n: int | None = None,
    tile_n: int = 256,
    t_per_tile: int = 4,
    counter=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MIPS over a dense index (counterpart of
    ``mips_topk_pallas2_t``): per-tile top-T scan, then the exact top-k
    merge -> (scores (B, k) f32, ids (B, k) int32).

    ``valid_n`` masks rows at or past it (runtime count); ``pool_n`` is a
    lower bound on valid rows for the per-tile pool depth. ``tile_n`` is the
    emit tile: 256 against the TPU's 2048 (a tile of scores has to fit one
    block's shared memory), clamped to ``round_up(N, 128)``. ``counter``
    goes to the scan (``scan_topt_dense``)."""
    b = queries.shape[0]
    n = emb_rows.shape[0]
    k = min(k, n)
    valid_n = n if valid_n is None else int(valid_n)
    tile_n, t = scan_geometry(n, k, pool_n, tile_n, t_per_tile)
    cand_s, cand_i = scan_topt_dense(
        dense_query(queries, emb_rows), emb_rows, valid_n, tile_n, t,
        counter=counter)
    cand_s = cand_s.permute(1, 0, 2).reshape(b, -1)
    cand_i = cand_i.permute(1, 0, 2).reshape(b, -1)
    return _merge_candidates(cand_s, cand_i, k, b)


def mips_topk_dense(queries: torch.Tensor, emb_rows: torch.Tensor, k: int,
                    *, tile_n: int = 256, t_per_tile: int = 4):
    """Fused MIPS over row-major dense rows, every row valid (counterpart
    of ``mips_topk_pallas2``, ``mips_pallas2.py:91-160``, kernel B6):
    queries (B, d) bf16 or f32, ``emb_rows`` (N, d) bf16 or f32 -> (scores
    (B, k) f32, ids (B, k) int32). The Pallas kernel ``_topt_kernel``
    (:73-88) is ``_topt_kernel_t``'s function on rows, so on a CUDA tensor
    this launches kernel B3's instance with the valid count N (counted in
    ``mips_topk_dense.launches``); a CPU tensor takes its plain version. A
    bf16 query against bf16 rows is one plane and scores exactly
    bf16 x bf16 (``dense_query``). The pool
    depth T is ``_pool_t`` over the port's emit tile (256, clamped to
    ``round_up(N, 128)``): exact for k <= T."""
    return mips_topk_dense_t(queries, emb_rows, k, tile_n=tile_n,
                             t_per_tile=t_per_tile, counter=mips_topk_dense)


mips_topk_dense.launches = 0


# -------------------------------------------------------------- fp16 scan
F16 = (torch.float16,)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """int32 exponents in [-126, 127] -> exactly 2^e as float32."""
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def f16_query_planes(q: torch.Tensor, planes: int):
    """The fp16 kernels' query: each f32 row scaled by the power of two s
    that brings max|q*s| into [0.5, 1) (exact; s = 1 for a zero row), then
    q_h = fp16(q*s) and, with two planes, q_l = fp16((q*s - q_h) * 2^11)
    (q*s - q_h is exact in f32). -> (q_h, q_l or None, 1/s (B,) f32).

    The scaled query keeps fp16's 11 bits where fp16(q) would go subnormal
    (|q_i| < 2^-14 max|q|); elsewhere fp16(q*s)/s == fp16(q)."""
    _, e = torch.frexp(q.abs().amax(dim=1))
    e = e.to(torch.int32).clamp(-100, 100)
    qs = q * _pow2(-e)[:, None]
    qh = qs.to(torch.float16)
    ql = None
    if planes == 2:
        ql = ((qs - qh.to(torch.float32)) * 2.0 ** 11).to(torch.float16)
    return qh, ql, _pow2(e)


def scan_topt_f16h_plain(q, emb, valid_n: int, tile_n: int,
                         t_per_tile: int):
    """Plain PyTorch version of kernel B4: the f32 product of q_h (the
    scaled fp16 query of ``f16_query_planes``) with the stored fp16 rows
    (TF32 off on the card), times 1/s; the valid-count mask and the
    per-tile top-T of ``_tile_topt_plain``. Equal to
    ``q.half().float() @ rows.float().T`` wherever q is in fp16's normal
    range."""
    _check_dense_args(q, emb, valid_n, tile_n, t_per_tile, F16)
    if q.device.type == "cuda":
        exact_f32_matmul()
    qh, _, inv_s = f16_query_planes(q, 1)
    qh, inv_s = qh.to(torch.float32), inv_s[:, None]

    def score_rows(lo, hi):
        return (qh @ emb[lo:hi].to(torch.float32).T) * inv_s

    return _tile_topt_plain(score_rows, q.shape[0], emb.shape[0], valid_n,
                            tile_n, t_per_tile, emb.device)


def scan_topt_f16_plain(q, emb, valid_n: int, tile_n: int,
                        t_per_tile: int):
    """Plain PyTorch version of kernel B5: the f32 product of the f32
    query with the stored fp16 values (TF32 off on the card), the mask and
    the per-tile top-T."""
    _check_dense_args(q, emb, valid_n, tile_n, t_per_tile, F16)
    if q.device.type == "cuda":
        exact_f32_matmul()

    def score_rows(lo, hi):
        return q @ emb[lo:hi].to(torch.float32).T

    return _tile_topt_plain(score_rows, q.shape[0], emb.shape[0], valid_n,
                            tile_n, t_per_tile, emb.device)


def _scan_f16(entry: str, planes: int, q, emb, valid_n, tile_n, t_per_tile,
              counter):
    """Launch one fp16 instance of ``csrc/topt_dense.cu`` on CUDA tensors,
    counted in ``counter.launches``."""
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_dense_args(q, emb, valid_n, tile_n, t_per_tile, F16)
    b, d = q.shape
    n_rows = emb.shape[0]
    qh, ql, inv_s = f16_query_planes(q, planes)
    qplanes = (qh,) if ql is None else (qh, ql)
    n_tiles = _check_launch(b, d, n_rows, tile_n, (*qplanes, emb))
    return _launch(entry, getattr(_kernel_libs()["topt_dense"],
                                  f"{entry}_launch"),
                   (*(t.data_ptr() for t in qplanes), inv_s.data_ptr(),
                    emb.data_ptr(), b, d, n_rows, int(valid_n), tile_n,
                    t_per_tile), b, n_tiles, t_per_tile, emb.device, counter)


def scan_topt_f16h(q, emb, valid_n: int, tile_n: int, t_per_tile: int):
    """Coarse fp16 scan + per-tile top-T emit -> (scores, ids), each
    (ceil(N / tile_n), B, T): q (B, d) f32, emb (N, d) ``torch.float16``
    rows; columns at or past ``valid_n`` score NEG_INF. The query goes in
    as one fp16 plane (``f16_query_planes``). CPU tensors take the plain
    version; CUDA tensors launch kernel B4 (counted in
    ``scan_topt_f16h.launches``) or raise — there is no fallback."""
    if emb.device.type == "cpu":
        return scan_topt_f16h_plain(q, emb, valid_n, tile_n, t_per_tile)
    return _scan_f16("topt_f16h", 1, q, emb, valid_n, tile_n, t_per_tile,
                     scan_topt_f16h)


scan_topt_f16h.launches = 0


def scan_topt_f16(q, emb, valid_n: int, tile_n: int, t_per_tile: int, *,
                  counter=None):
    """fp16-exact scan + per-tile top-T emit -> (scores, ids), as
    ``scan_topt_f16h`` but with the query as two fp16 planes, which keeps
    it to ~22 bits. CPU tensors take the plain version; CUDA tensors launch
    kernel B5 (counted in ``scan_topt_f16.launches``, or in
    ``counter.launches`` when given) or raise."""
    if emb.device.type == "cpu":
        return scan_topt_f16_plain(q, emb, valid_n, tile_n, t_per_tile)
    return _scan_f16("topt_f16", 2, q, emb, valid_n, tile_n, t_per_tile,
                     counter or scan_topt_f16)


scan_topt_f16.launches = 0


def mips_topk_f16_t(
    queries: torch.Tensor,   # (B, d)
    emb_rows: torch.Tensor,  # (N, d) torch.float16
    k: int,
    *,
    valid_n: int | None = None,
    pool_n: int | None = None,
    tile_n: int = 256,
    t_per_tile: int = 4,
    refine: int = 0,
    counter=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MIPS over an fp16 index (counterpart of
    ``mips_topk_pallas2_f16_t``) -> (scores (B, k) f32, ids (B, k) int32).

    ``refine=r>0``: the coarse scan (kernel B4) and the exact merge to the
    top-(r*k), rescored in f32 from the rows by ``_f16_refine``.
    ``refine=0``: fp16-exact scores (kernel B5), merged to the top-k.
    ``valid_n``/``pool_n``/``tile_n``/``counter`` as in
    ``mips_topk_dense_t``."""
    b = queries.shape[0]
    n = emb_rows.shape[0]
    k = min(k, n)
    k_sel = min(refine * k, n) if refine else k
    valid_n = n if valid_n is None else int(valid_n)
    tile_n, t = scan_geometry(n, k_sel, pool_n, tile_n, t_per_tile)
    q = queries.to(torch.float32).contiguous()
    if refine:
        cand_s, cand_i = scan_topt_f16h(q, emb_rows, valid_n, tile_n, t)
    else:
        cand_s, cand_i = scan_topt_f16(q, emb_rows, valid_n, tile_n, t,
                                       counter=counter)
    cand_s = cand_s.permute(1, 0, 2).reshape(b, -1)
    cand_i = cand_i.permute(1, 0, 2).reshape(b, -1)
    if not refine:
        return _merge_candidates(cand_s, cand_i, k, b)
    _, ids = _merge_candidates(cand_s, cand_i, k_sel, b)
    return _f16_refine(q, emb_rows, ids, k, valid_n)


def mips_topk_f16(queries: torch.Tensor, emb_rows: torch.Tensor, k: int, *,
                  tile_n: int = 256, t_per_tile: int = 4):
    """Fused MIPS over row-major fp16 rows, every row valid (counterpart of
    ``mips_topk_pallas2_f16``, ``mips_pallas2.py:350-425``, kernel B7):
    queries (B, d), ``emb_rows`` (N, d) ``torch.float16`` -> (scores (B, k)
    f32, ids (B, k) int32). The JAX package stores fp16 as int16 bits and
    its ``_topt_f16_kernel`` (:326-347) decodes them and scores three bf16
    passes (~16 bits of the query, subnormals flushed); here the rows are
    native fp16 and a CUDA tensor launches kernel B5's instance (two fp16
    query planes, ~22 bits, subnormals kept) with the valid count N,
    counted in ``mips_topk_f16.launches``; a CPU tensor takes its plain
    version. T as in ``mips_topk_dense``."""
    return mips_topk_f16_t(queries, emb_rows, k, tile_n=tile_n,
                           t_per_tile=t_per_tile, counter=mips_topk_f16)


mips_topk_f16.launches = 0


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


def _f16_refine(q, emb_rows, ids, k: int, nv: int):
    """Rescore coarse candidates at f32 from the fp16 rows
    (``mips_pallas2.py::_f16_refine``, rows gather): the stored fp16 values
    converted exactly, an f32 product with TF32 off, ids outside [0, nv) —
    the -1 sentinel included, whose clipped gather read row 0 — masked to
    NEG_INF, then the top-k."""
    if q.device.type == "cuda":
        exact_f32_matmul()
    x = emb_rows[ids.long().clamp(0, emb_rows.shape[0] - 1)].to(torch.float32)
    s = torch.einsum("bd,bkd->bk", q, x)
    s = torch.where((ids >= 0) & (ids < nv), s, NEG_INF)
    v, a = torch.topk(s, k, dim=1)
    return v, torch.gather(ids, 1, a)


def _int8r_refine(q, emb_q, scale, res_rows, res_scale, ids, k: int,
                  nv: int):
    """The int8r ``cols`` refine (``mips_pallas2.py::_int8r_refine``): both
    planes of each candidate gathered (plane 1 is row-major here, so the
    JAX package's column gather is a row gather), x = v1*s1 + v2*s2 in f32,
    an f32 product, ids outside [0, nv) masked, then the top-k."""
    if q.device.type == "cuda":
        exact_f32_matmul()
    flat = ids.long().clamp(0, emb_q.shape[0] - 1)
    x = (emb_q[flat].to(torch.float32) * scale.reshape(-1)[flat, None]
         + res_rows[flat].to(torch.float32)
         * res_scale.reshape(-1)[flat, None])
    s = torch.einsum("bd,bkd->bk", q, x)
    s = torch.where((ids >= 0) & (ids < nv), s, NEG_INF)
    v, a = torch.topk(s, k, dim=1)
    return v, torch.gather(ids, 1, a)


def hybrid_int8_from_f16(rows: torch.Tensor):
    """The hybrid index's coarse copy (``mips_pallas2.py::
    hybrid_int8_from_bits``): the stored fp16 rows converted exactly to f32
    (subnormals kept), then ``quantize_int8`` per row -> (codes (rows, d)
    int8, scales (rows,) f32)."""
    v, s = quantize_int8(rows.to(torch.float32))
    return v, s[:, 0]


def mips_topk_int8_t(
    queries: torch.Tensor,    # (B, d) f32
    emb_rows: torch.Tensor,   # (N, d) int8: the coarse rows (plane 1)
    emb_scale: torch.Tensor,  # (1, N) f32: their row scales
    k: int,
    *,
    valid_n: int | None = None,
    pool_n: int | None = None,
    tile_n: int = 256,
    t_per_tile: int = 4,
    refine: int = 0,
    f16_rows: torch.Tensor | None = None,   # (N, d) fp16: hybrid
    res_rows: torch.Tensor | None = None,   # (N, d) int8: int8r plane 2
    res_scale: torch.Tensor | None = None,  # (1, N) f32
    int8r_refine: str = "rows",
    counter=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused MIPS over an int8 index: counterpart of
    ``mips_topk_pallas2_int8_t`` -> (scores (B, k) f32, ids (B, k) int32).

    ``refine=0``: the int8 scores, merged (int8 storage). ``refine=r>0``
    with ``f16_rows``: the hybrid index — the coarse top-(r*k) rescored by
    ``_f16_refine``. ``refine=r>0`` with ``res_rows``: int8r, by
    ``int8r_refine``: "rows" is ``mips_topk_int8r_t`` (two-plane query,
    kernel B1); "rows1" scans with one plane and adds the plane-2 term
    (``_int8r_rows_refine``); "cols" rebuilds both planes (``_int8r_refine``).
    Every scan but "rows" is kernel B2. ``valid_n``/``pool_n``/``tile_n``
    as in ``mips_topk_int8r_t``; ``counter`` goes to ``scan_topt_int8``."""
    if refine and f16_rows is None and res_rows is None:
        raise ValueError(
            "int8 refine needs f16_rows (hybrid) or res_rows (residual)")
    if res_rows is not None and res_scale is None:
        raise ValueError("res_rows requires res_scale")
    if int8r_refine not in ("rows", "rows1", "cols"):
        raise ValueError(f"int8r_refine must be rows|rows1|cols, got "
                         f"{int8r_refine!r}")
    if refine and res_rows is not None and int8r_refine == "rows":
        return mips_topk_int8r_t(
            queries, emb_rows, emb_scale, k, res_rows=res_rows,
            res_scale=res_scale, valid_n=valid_n, pool_n=pool_n,
            tile_n=tile_n, t_per_tile=t_per_tile, refine=refine)
    b = queries.shape[0]
    n = emb_rows.shape[0]
    k = min(k, n)
    k_sel = min(refine * k, n) if refine else k
    valid_n = n if valid_n is None else int(valid_n)
    tile_n, t = scan_geometry(n, k_sel, pool_n, tile_n, t_per_tile)
    q = queries.to(torch.float32)
    qv, qs = quantize_int8(q)
    cand_s, cand_i = scan_topt_int8(qv, qs, emb_rows, emb_scale, valid_n,
                                    tile_n, t, counter=counter)
    cand_s = cand_s.permute(1, 0, 2).reshape(b, -1)
    cand_i = cand_i.permute(1, 0, 2).reshape(b, -1)
    if not refine:
        return _merge_candidates(cand_s, cand_i, k, b)
    vals, ids = _merge_candidates(cand_s, cand_i, k_sel, b)
    if res_rows is None:
        return _f16_refine(q, f16_rows, ids, k, valid_n)
    if int8r_refine == "rows1":
        return _int8r_rows_refine(q, vals, res_rows, res_scale, ids, k,
                                  valid_n)
    return _int8r_refine(q, emb_rows, emb_scale, res_rows, res_scale, ids, k,
                         valid_n)


def mips_topk_int8(queries: torch.Tensor, emb_q: torch.Tensor,
                   emb_scale: torch.Tensor, k: int, *, tile_n: int = 256,
                   t_per_tile: int = 4):
    """Fused MIPS over a row-major int8 index, every row valid (counterpart
    of ``mips_topk_pallas2_int8``, ``mips_pallas2.py:948-1028``, kernel
    B8): queries (B, d) f32, ``emb_q`` (N, d) int8 codes and ``emb_scale``
    (N, 1) f32 row scales -> (scores (B, k) f32, ids (B, k) int32). The
    query is quantised by ``quantize_int8`` (the JAX package's codes bit
    for bit) and scored as ``(acc * qs) * es``; the Pallas kernel
    ``_topt_int8_kernel`` (:705-721) is ``_topt_int8_kernel_t``'s function
    on rows, so a CUDA tensor launches kernel B2's instance with the valid
    count N (counted in ``mips_topk_int8.launches``); a CPU tensor takes
    its plain version. T as in ``mips_topk_dense``."""
    if emb_scale.numel() != emb_q.shape[0]:
        raise ValueError(f"emb_scale has {emb_scale.numel()} elements, want "
                         f"{emb_q.shape[0]}")
    return mips_topk_int8_t(queries, emb_q, emb_scale.reshape(1, -1), k,
                            tile_n=tile_n, t_per_tile=t_per_tile,
                            counter=mips_topk_int8)


mips_topk_int8.launches = 0


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
    tile_n, t = scan_geometry(n, k_sel, pool_n, tile_n, t_per_tile)
    with trace.span("mips.quantize"):
        q = queries.to(torch.float32)
        qv1, qs1, qv2, qs2 = quantize_int8_residual(q)
    with trace.span("mips.scan"):
        cand_s, cand_i = scan_topt_int8r2(qv1, qs1, qv2, qs2, emb_rows,
                                          emb_scale, valid_n, tile_n, t)
        cand_s = cand_s.permute(1, 0, 2).reshape(b, -1)
        cand_i = cand_i.permute(1, 0, 2).reshape(b, -1)
    with trace.span("mips.merge"):
        vals, ids = _merge_candidates(cand_s, cand_i, k_sel, b)
    with trace.span("mips.refine"):
        return _int8r_rows_refine(q, vals, res_rows, res_scale, ids, k,
                                  valid_n)
