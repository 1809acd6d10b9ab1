"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one. They import torch
only, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances. B1 (int8r) and B2 (single-plane int8): the kernel and the plain
version do the same f32 arithmetic in the same order on the same exact
integer sums (s32 on wgmma, exact f32 or f64 products in the plain
version), so candidate scores are equal bit for bit and ids are equal
except among tied scores.
B3 (dense): the bf16 kernel scores the (hi, lo) bf16 split of the f32 query,
which leaves <= 2^-18 * sum|q_i x_i| per score, and sums in another order
than cuBLAS's f32 product; for unit-norm rows and queries the scores agree
to 1e-4 absolute at bf16 and 1e-5 at f32. Ids are equal except among
candidates whose scores lie within that tolerance of each other: where the
ids differ, the kernel's row scores within twice the tolerance of the plain
version's row.
B4 and B5 (fp16 rows): B4's plain version multiplies the same fp16 query
plane by the rows in f32, so only the order of the f32 sums differs; B5
scores the f32 query split into two fp16 planes (<= 2^-22 * sum|q_i x_i|
left) against the plain version's f32 product. Both agree to 1e-5 of
|q|·|x| (the effective query's norm times the row's), the bound for unit
rows at d = 1024, and ids as for B3.
The 16-bit kernels (B3-B7, B9) score on wgmma: a bf16 query is one plane;
an f32 query's hi and lo planes accumulate into one f32 sum (each product
exact, the order of the sums moved), within the same bounds.
B6, B7 and B8 (the row-major wrappers over B3's, B5's and B2's instances)
and B9 (the exact streaming top-k, B3's scoring core): the final top-k on
the card against the CPU path (the plain versions): sorted scores within
B3's bound (1e-4·|q|·|x| for bf16 rows, 1e-5 for f32 and fp16, 1e-5
relative for int8), distinct valid ids, and where an id differs its score
(f64 on the stored values) within twice the bound of the plain version's
at that rank; tied rows give equal score multisets."""

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.ops import mips_stream as tstream
from jsa_rag_tpu_torch.ops import mips_topt as tp2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _assert_same_candidates(ks, ki, ps, pi):
    ks, ki, ps, pi = (x.cpu().numpy() for x in (ks, ki, ps, pi))
    np.testing.assert_array_equal(ks, ps)
    # a differing id is allowed only where its score ties another
    # candidate of the same (tile, row) list
    for nt, r, p in np.argwhere(ki != pi):
        assert (ks[nt, r] == ks[nt, r, p]).sum() > 1, (nt, r, p)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nv,d,k_sel,tile", [
    (64, 8192, 8000, 1024, 400, 256),
    (5, 4099, 3000, 1024, 4096, 256),
    (40, 1000, 1000, 256, 64, 128),
    (33, 777, 700, 80, 50, 128),  # d not a multiple of the 128-byte stage
    (130, 777, 700, 80, 50, 128),  # and a third tile of 64 queries
])
def test_kernel_matches_plain(cuda, b, n, nv, d, k_sel, tile):
    g = torch.Generator(device=cuda).manual_seed(b + n)
    v1, s1, _, _ = tp2.quantize_int8_residual(
        torch.randn((n, d), generator=g, device=cuda))
    qv1, qs1, qv2, qs2 = tp2.quantize_int8_residual(
        torch.randn((b, d), generator=g, device=cuda))
    t = tp2._pool_t(k_sel, nv, tile, 4)
    args = (qv1, qs1, qv2, qs2, v1, s1.reshape(1, -1), nv, tile, t)
    before = tp2.scan_topt_int8r2.launches
    ks, ki = tp2.scan_topt_int8r2(*args)
    ps, pi = tp2.scan_topt_int8r2_plain(*args)
    torch.cuda.synchronize()
    assert tp2.scan_topt_int8r2.launches == before + 1
    assert ks.shape == (-(-n // tile), b, t) and ki.dtype == torch.int32
    assert int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
def test_kernel_grid_past_65535_index_tiles(cuda):
    """More index tiles than a grid's y dimension holds (65,535): the 1-D
    grid reaches them all, with two query tiles so the block index splits
    into both parts. A short d keeps the 8.4M-row plane at 134 MB."""
    tile, d, b = 128, 16, 40
    n = 65_536 * tile + 300
    nv = n - 5
    g = torch.Generator(device=cuda).manual_seed(11)
    v1, s1, _, _ = tp2.quantize_int8_residual(
        torch.randn((n, d), generator=g, device=cuda))
    qv1, qs1, qv2, qs2 = tp2.quantize_int8_residual(
        torch.randn((b, d), generator=g, device=cuda))
    t = tp2._pool_t(400, nv, tile, 4)
    args = (qv1, qs1, qv2, qs2, v1, s1.reshape(1, -1), nv, tile, t)
    ks, ki = tp2.scan_topt_int8r2(*args)
    ps, pi = tp2.scan_topt_int8r2_plain(*args)
    torch.cuda.synchronize()
    assert ks.shape == (-(-n // tile), b, t)
    assert int(ki[65_535:].min()) >= 65_535 * tile
    assert int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
def test_search_on_card_matches_cpu(cuda):
    """The whole scan-merge-refine on the card returns what the CPU path
    (plain scan) returns for the same planes."""
    g = torch.Generator().manual_seed(3)
    n, d, b, k = 5000, 512, 9, 50
    e = torch.randn((n, d), generator=g)
    v1, s1, v2, s2 = tp2.quantize_int8_residual(e)
    q = e[:b] + 0.05 * torch.randn((b, d), generator=g)
    planes = (v1, s1.reshape(1, -1), v2, s2.reshape(1, -1))
    cs, ci = tp2.mips_topk_int8r_t(q, planes[0], planes[1], k,
                                   res_rows=planes[2], res_scale=planes[3],
                                   valid_n=4900)
    gs, gi = tp2.mips_topk_int8r_t(
        q.to(cuda), *(p.to(cuda) for p in planes[:2]), k,
        res_rows=planes[2].to(cuda), res_scale=planes[3].to(cuda),
        valid_n=4900)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (gi[:, 0].cpu() == torch.arange(b)).all()
    assert int(gi.max()) < 4900


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,nv,d,k_sel,tile", [
    (2, 8192, 7415, 1024, 40, 256),   # the train step: prior + posterior
    (64, 8192, 8000, 1024, 40, 256),
    (512, 4096, 4000, 1024, 400, 256),
    (5, 4099, 3000, 1024, 4096, 256),  # more candidates than valid rows
    (33, 777, 700, 80, 50, 128),
    (130, 777, 700, 80, 50, 128),  # d < 128 and a second tile of 128
])
def test_int8_kernel_matches_plain(cuda, b, n, nv, d, k_sel, tile):
    """Kernel B2 (one query plane) against ``scan_topt_int8_plain``."""
    g = torch.Generator(device=cuda).manual_seed(b + n + 1)
    v, s = tp2.quantize_int8(torch.randn((n, d), generator=g, device=cuda))
    qv, qs = tp2.quantize_int8(torch.randn((b, d), generator=g, device=cuda))
    t = tp2._pool_t(k_sel, nv, tile, 4)
    args = (qv, qs, v, s.reshape(1, -1), nv, tile, t)
    before = tp2.scan_topt_int8.launches
    ks, ki = tp2.scan_topt_int8(*args)
    ps, pi = tp2.scan_topt_int8_plain(*args)
    torch.cuda.synchronize()
    assert tp2.scan_topt_int8.launches == before + 1
    assert ks.shape == (-(-n // tile), b, t) and ki.dtype == torch.int32
    assert int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
def test_int8_kernel_grid_past_65535_index_tiles(cuda):
    """Kernel B2 over 65,537 index tiles of 128 rows with two query
    tiles (d = 16 keeps the plane at 134 MB)."""
    tile, d, b = 128, 16, 40
    n = 65_536 * tile + 300
    nv = n - 5
    g = torch.Generator(device=cuda).manual_seed(17)
    v, s = tp2.quantize_int8(torch.randn((n, d), generator=g, device=cuda))
    qv, qs = tp2.quantize_int8(torch.randn((b, d), generator=g, device=cuda))
    t = tp2._pool_t(400, nv, tile, 4)
    args = (qv, qs, v, s.reshape(1, -1), nv, tile, t)
    ks, ki = tp2.scan_topt_int8(*args)
    ps, pi = tp2.scan_topt_int8_plain(*args)
    torch.cuda.synchronize()
    assert int(ki[65_535:].min()) >= 65_535 * tile
    assert int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2"])
@pytest.mark.parametrize("b", [1, 2, 8, 63, 64, 65, 257, 512, 1000])
@pytest.mark.parametrize("d,tile,t", [(1024, 256, 4), (1024, 128, None),
                                      (80, 128, 3), (80, 256, None)])
def test_int8_kernels_batch_sizes(cuda, kernel, b, d, tile, t):
    """B1 and B2 on the int8 wgmma core at every batch size of its query
    tiles (64 queries a unit for B1's interleaved planes, 128 for B2; 63,
    65, 257 and 1000 end in a partial tile, 1-8 load only their own rows;
    B1 on the overlapped schedule at every one), at valid_n < N over an odd
    number of index tiles with a ragged last one, at emit tiles 256 and
    128, at d = 80 (one short stage a unit), at T of 3 and 4 and of 400
    candidates: the candidates' scores equal the plain version's bit for
    bit, ids equal except among tied scores."""
    g = torch.Generator(device=cuda).manual_seed(b + len(kernel) + d + 29)
    n = 79 * 256 - 5  # 79 index tiles, the last ragged
    nv = n - 60
    v1, s1, _, _ = tp2.quantize_int8_residual(
        torch.randn((n, d), generator=g, device=cuda))
    qv1, qs1, qv2, qs2 = tp2.quantize_int8_residual(
        torch.randn((b, d), generator=g, device=cuda))
    t = t or tp2._pool_t(400, nv, tile, 4)
    if kernel == "B1":
        scan, plain = tp2.scan_topt_int8r2, tp2.scan_topt_int8r2_plain
        args = (qv1, qs1, qv2, qs2, v1, s1.reshape(1, -1), nv, tile, t)
    else:
        scan, plain = tp2.scan_topt_int8, tp2.scan_topt_int8_plain
        args = (qv1, qs1, v1, s1.reshape(1, -1), nv, tile, t)
    before = scan.launches
    ks, ki = scan(*args)
    ps, pi = plain(*args)
    torch.cuda.synchronize()
    assert scan.launches == before + 1
    assert ks.shape == (-(-n // tile), b, t) and int(ki.max()) < nv
    _assert_same_candidates(ks, ki, ps, pi)


@pytest.mark.cuda
def test_int8_geometry_mirrors_the_library(cuda):
    """``int8_scan_geometry`` (pure Python) equals what
    ``csrc/topt_int8r2.cu`` computes for a launch: the query box, the query
    tiles, the ring's stages, the persistent grid, the schedule and the
    block's threads."""
    import ctypes

    lib = tp2._kernel_libs()["topt_int8r2"]
    out = (ctypes.c_int * 6)()
    for planes in (1, 2):
        for b in (1, 2, 7, 8, 9, 63, 64, 65, 127, 128, 129, 257, 512, 1000,
                  4096):
            for n_rows, sms in ((1, 132), (300, 132), (1_300_000, 132),
                                (79 * 256 - 5, 132), (4096, 7)):
                assert lib.topt_int8_geometry(b, planes, n_rows, sms,
                                              out) == 0
                g = tp2.int8_scan_geometry(b, planes, n_rows, sms)
                assert list(out) == [
                    g["qbox"], g["q_tiles"], g["stages"], g["grid"],
                    tp2.INT8_SCHEDULES.index(g["schedule"]), g["threads"]
                ], (planes, b, n_rows, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["int8", "hybrid", "rows1", "cols"])
def test_int8_search_on_card_matches_cpu(cuda, branch):
    """Every B2 branch of ``mips_topk_int8_t`` on the card returns the
    CPU path's (plain scan) top-k, gold top-1 included."""
    g = torch.Generator().manual_seed(7)
    n, d, b, k = 5000, 512, 9, 50
    e = torch.randn((n, d), generator=g)
    e = e / e.norm(dim=1, keepdim=True)
    q = e[:b] + 0.05 * torch.randn((b, d), generator=g)
    if branch == "int8":
        v, s = tp2.quantize_int8(e)
        ops, kw = (v, s.reshape(1, -1)), {}
    elif branch == "hybrid":
        f16 = e.to(torch.float16)
        v, s = tp2.hybrid_int8_from_f16(f16)
        ops, kw = (v, s.reshape(1, -1)), dict(refine=4, f16_rows=f16)
    else:
        v1, s1, v2, s2 = tp2.quantize_int8_residual(e)
        ops = (v1, s1.reshape(1, -1))
        kw = dict(refine=4, res_rows=v2, res_scale=s2.reshape(1, -1),
                  int8r_refine=branch)
    cs, ci = tp2.mips_topk_int8_t(q, *ops, k, valid_n=4900, **kw)
    before = tp2.scan_topt_int8.launches
    gs, gi = tp2.mips_topk_int8_t(
        q.to(cuda), *(o.to(cuda) for o in ops), k, valid_n=4900,
        **{k_: (v_.to(cuda) if torch.is_tensor(v_) else v_)
           for k_, v_ in kw.items()})
    assert tp2.scan_topt_int8.launches == before + 1
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=1e-5,
                               atol=1e-5)
    if branch != "int8":
        assert (gi[:, 0].cpu() == torch.arange(b)).all()
    assert int(gi.max()) < 4900


def _unit(g, shape, dev):
    x = torch.randn(shape, generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def _assert_dense_close(q, emb, ks, ki, ps, pi, atol):
    ks, ki, ps, pi = (x.cpu().numpy() for x in (ks, ki, ps, pi))
    live = pi >= 0
    assert (ki >= 0).tolist() == live.tolist()  # same exhausted slots
    np.testing.assert_allclose(ks[live], ps[live], rtol=0, atol=atol)
    assert (ks[~live] == ps[~live]).all()
    # where the ids differ, the kernel's row must score (in f64, on the
    # stored values) within the tolerance of the plain version's row
    where = np.argwhere(ki != pi)
    if len(where):
        rows = torch.from_numpy(ki[tuple(where.T)].astype(np.int64))
        true = (q.double().cpu()[torch.from_numpy(where[:, 1])]
                * emb[rows.to(emb.device)].double().cpu()).sum(-1).numpy()
        np.testing.assert_allclose(true, ps[tuple(where.T)], rtol=0,
                                   atol=2 * atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 1e-4),
                                        ("float32", 1e-5)])
@pytest.mark.parametrize("b,n,nv,d,k_sel", [
    (64, 8192, 8000, 1024, 400),
    (8, 20_000, 19_990, 1024, 40),   # the eval batch: one 32-row tile
    (5, 4099, 3000, 256, 4096),      # the demo's d; pool > valid rows
    (33, 777, 700, 256, 50),         # B not a multiple of 16
    (3, 100, 90, 16, 7),             # N <= 128: the tile clamps to 128
    (17, 2048, 300, 64, 400),        # mostly padded tiles: -1 slots
])
def test_dense_kernel_matches_plain(cuda, dtype, atol, b, n, nv, d, k_sel):
    g = torch.Generator(device=cuda).manual_seed(b + n + d)
    emb = _unit(g, (n, d), cuda).to(getattr(torch, dtype))
    q = _unit(g, (b, d), cuda)
    tile = min(256, tp2._round_up(n, 128))
    t = tp2._pool_t(k_sel, nv, tile, 4)
    before = tp2.scan_topt_dense.launches
    ks, ki = tp2.scan_topt_dense(q, emb, nv, tile, t)
    ps, pi = tp2.scan_topt_dense_plain(q, emb, nv, tile, t)
    torch.cuda.synchronize()
    assert tp2.scan_topt_dense.launches == before + 1
    assert ks.shape == (-(-n // tile), b, t) and ki.dtype == torch.int32
    assert int(ki.max()) < nv
    _assert_dense_close(q, emb, ks, ki, ps, pi, atol)


@pytest.mark.cuda
def test_dense_kernel_grid_past_65535_index_tiles(cuda):
    """65,538 index tiles of 128 rows on the one-dimensional grid, bf16,
    with two query tiles; d = 16 keeps the 8.4M-row index at 268 MB."""
    tile, d, b = 128, 16, 40
    n = 65_537 * tile + 5
    nv = n - 3
    g = torch.Generator(device=cuda).manual_seed(13)
    emb = _unit(g, (n, d), cuda).to(torch.bfloat16)
    q = _unit(g, (b, d), cuda)
    t = tp2._pool_t(400, nv, tile, 4)
    ks, ki = tp2.scan_topt_dense(q, emb, nv, tile, t)
    ps, pi = tp2.scan_topt_dense_plain(q, emb, nv, tile, t)
    torch.cuda.synchronize()
    assert ks.shape == (-(-n // tile), b, t)
    tail = ki[65_535:]
    assert int(tail[tail >= 0].min()) >= 65_535 * tile
    assert int(ki.max()) < nv
    _assert_dense_close(q, emb, ks, ki, ps, pi, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_search_on_card_matches_cpu(cuda, dtype):
    """``mips_topk_dense_t`` on the card returns the CPU path's (plain
    scan) top-k for the same rows, gold top-1 included."""
    g = torch.Generator().manual_seed(5)
    n, d, b, k = 5000, 256, 9, 50
    e = torch.randn((n, d), generator=g)
    e = (e / e.norm(dim=1, keepdim=True)).to(getattr(torch, dtype))
    q = e[:b].float() + 0.01 * torch.randn((b, d), generator=g)
    cs, ci = tp2.mips_topk_dense_t(q, e, k, valid_n=4900)
    gs, gi = tp2.mips_topk_dense_t(q.to(cuda), e.to(cuda), k, valid_n=4900)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=0,
                               atol=1e-4)
    assert (gi[:, 0].cpu() == torch.arange(b)).all()
    assert int(gi.max()) < 4900


F16_RTOL = 1e-5


def _f16_case(g, b, n, d, dev, subnormal_rows=0):
    emb = _unit(g, (n, d), dev)
    emb[:subnormal_rows] *= 2e-5  # every component an fp16 subnormal
    return emb.to(torch.float16), _unit(g, (b, d), dev)


def _assert_f16_close(kind, q, emb, ks, ki, ps, pi):
    """Scores within F16_RTOL·|q|·|x| of the plain version's, the same
    exhausted slots; where ids differ, the kernel's row scores (in f64 on
    the stored values, with the query the kernel reads) within twice that
    of the plain version's pick."""
    if kind == "f16h":
        qh, _, inv_s = tp2.f16_query_planes(q, 1)
        q = qh.float() * inv_s[:, None]
    live = pi >= 0
    assert torch.equal(ki >= 0, live)
    assert torch.equal(ks[~live], ps[~live])
    xn = torch.linalg.vector_norm(emb, dim=1, dtype=torch.float32)
    tol = F16_RTOL * q.norm(dim=1)[None, :, None] * xn[pi.clamp(min=0).long()]
    err = torch.where(live, (ks - ps).abs(), 0.0)
    assert bool((err <= tol).all()), float((err / tol.clamp_min(1e-30)).max())
    differ = ki != pi
    where = differ.nonzero()
    if where.shape[0]:
        true = (q.double()[where[:, 1]] * emb[ki[differ].long()].double()
                ).sum(-1)
        assert bool(((true - ps[differ].double()).abs()
                     <= 2 * tol[differ]).all())


def _run_f16(kind, q, emb, nv, tile, t):
    scan = getattr(tp2, f"scan_topt_{kind}")
    plain = getattr(tp2, f"scan_topt_{kind}_plain")
    before = scan.launches
    ks, ki = scan(q, emb, nv, tile, t)
    ps, pi = plain(q, emb, nv, tile, t)
    torch.cuda.synchronize()
    assert scan.launches == before + 1
    assert ks.shape == (-(-emb.shape[0] // tile), q.shape[0], t)
    assert ki.dtype == torch.int32 and int(ki.max()) < nv
    _assert_f16_close(kind, q, emb, ks, ki, ps, pi)
    return ks, ki


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f16h", "f16"])
@pytest.mark.parametrize("b,n,nv,d,k_sel", [
    (2, 8192, 7415, 1024, 40),       # the vrag step's prior + posterior
    (64, 8192, 8000, 1024, 400),
    (5, 4099, 3000, 1024, 4096),     # more candidates than valid rows
    (33, 777, 700, 80, 50),          # d not a multiple of the 64-elem stage
    (3, 100, 90, 16, 7),             # N <= 128: the tile clamps to 128
])
def test_f16_kernels_match_plain(cuda, kind, b, n, nv, d, k_sel):
    """Kernels B4 (``f16h``) and B5 (``f16``) against their plain
    versions."""
    g = torch.Generator(device=cuda).manual_seed(b + n + d + len(kind))
    emb, q = _f16_case(g, b, n, d, cuda)
    tile = min(256, tp2._round_up(n, 128))
    _run_f16(kind, q, emb, nv, tile, tp2._pool_t(k_sel, nv, tile, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f16h", "f16"])
def test_f16_kernel_grid_past_65535_index_tiles(cuda, kind):
    """65,538 index tiles of 128 fp16 rows on the one-dimensional grid,
    with two query tiles (d = 16 keeps the 8.4M rows at 268 MB)."""
    tile, d, b = 128, 16, 40
    n = 65_537 * tile + 5
    nv = n - 3
    g = torch.Generator(device=cuda).manual_seed(19)
    emb, q = _f16_case(g, b, n, d, cuda)
    _, ki = _run_f16(kind, q, emb, nv, tile, tp2._pool_t(400, nv, tile, 4))
    tail = ki[65_535:]
    assert int(tail[tail >= 0].min()) >= 65_535 * tile


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f16h", "f16"])
def test_f16_kernels_take_subnormal_rows(cuda, kind):
    """Rows whose every component is an fp16 subnormal score on the tensor
    cores as in the plain version (the JAX decode flushed them to zero)."""
    g = torch.Generator(device=cuda).manual_seed(23)
    emb, q = _f16_case(g, 16, 4096, 1024, cuda, subnormal_rows=2048)
    assert bool((emb[:2048].abs() < 2 ** -14).all())
    ks, ki = _run_f16(kind, q, emb, 2048, 256, 8)
    assert bool((ks[ki >= 0] != 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 4])
def test_f16_search_on_card_matches_cpu(cuda, refine):
    """``mips_topk_f16_t`` on the card returns the CPU path's (plain scans)
    top-k, gold top-1 included; with k above the valid rows every id is
    distinct (the -1 sentinel never resurfaces through the rescore)."""
    g = torch.Generator().manual_seed(5 + refine)
    n, d, b, k = 5000, 256, 9, 50
    e = torch.randn((n, d), generator=g)
    e = (e / e.norm(dim=1, keepdim=True)).to(torch.float16)
    q = e[:b].float() + 0.01 * torch.randn((b, d), generator=g)
    cs, ci = tp2.mips_topk_f16_t(q, e, k, valid_n=4900, refine=refine)
    gs, gi = tp2.mips_topk_f16_t(q.to(cuda), e.to(cuda), k, valid_n=4900,
                                 refine=refine)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=0,
                               atol=1e-5)
    assert (gi[:, 0].cpu() == torch.arange(b)).all()
    assert int(gi.max()) < 4900
    _, gi = tp2.mips_topk_f16_t(q.to(cuda), e[:128].to(cuda), 100,
                                valid_n=104, refine=refine)
    assert all(len(set(row)) == 100 for row in gi.cpu().tolist())
    assert int(gi.max()) < 104 and int(gi.min()) >= 0


# ------------------------------------------------- B6-B9: the row searches
def _assert_topk_close(q, emb, ks, ki, ps, pi, rtol):
    """The card's top-k against the plain version's: sorted scores within
    rtol·|q|·max|x|, distinct ids in [0, N), and a differing id's stored
    score within twice that of the plain version's at its rank."""
    n, k = emb.shape[0], ps.shape[1]
    ks, ki = ks.cpu(), ki.cpu()
    q, emb = q.float().cpu(), emb.cpu()
    assert ks.shape == ps.shape and ki.dtype == torch.int32
    assert int(ki.min()) >= 0 and int(ki.max()) < n
    assert all(len(set(r)) == k for r in ki.tolist())
    xn = torch.linalg.vector_norm(emb.float(), dim=1).max()
    tol = rtol * q.norm(dim=1, keepdim=True) * xn
    assert bool(((ks - ps).abs() <= tol).all()), float((ks - ps).abs().max())
    r, c = (ki != pi).nonzero(as_tuple=True)
    if r.numel():
        true = (q.double()[r] * emb[ki[r, c].long()].double()).sum(-1)
        assert bool(((true - ps[r, c].double()).abs()
                     <= 2 * tol[r, 0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,n,d,k", [
    ("bfloat16", 64, 262_144 - 777, 1024, 100),  # a ragged last tile
    ("bfloat16", 8, 20_000, 1024, 100),
    ("float32", 5, 4099, 256, 1000),             # qpb sized from k
    ("float32", 5, 4099, 256, 4099),             # k = N
    ("bfloat16", 5, 4099, 256, 1000),            # k = 1,000: lists in the output
    ("bfloat16", 130, 9000, 256, 239),           # the last k of shared lists
    ("bfloat16", 5, 4099, 256, 4099),            # k = N
    ("bfloat16", 40, 1000, 64, 300),             # slices shorter than k
])
def test_stream_kernel_matches_plain(cuda, dtype, b, n, d, k):
    """Kernel B9 against its plain version (the exact f32 top-k)."""
    g = torch.Generator(device=cuda).manual_seed(b + n + d)
    emb = _unit(g, (n, d), cuda).to(getattr(torch, dtype))
    q = _unit(g, (b, d), cuda)
    before = tstream.mips_topk_stream.launches
    ks, ki = tstream.mips_topk_stream(q, emb, k)
    torch.cuda.synchronize()
    assert tstream.mips_topk_stream.launches == before + 1
    ps, pi = tstream.mips_topk_stream_plain(q.cpu(), emb.cpu(), k)
    _assert_topk_close(q, emb, ks, ki, ps, pi,
                       1e-4 if dtype == "bfloat16" else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stream_kernel_tied_rows(cuda, dtype):
    """A slab of tied rows (scores repeat 64 times): the card returns the
    plain version's score multiset, every id once."""
    q = torch.ones((4, 32), device=cuda)
    e = torch.arange(16, dtype=torch.float32, device=cuda)[:, None]
    e = e.repeat(64, 32).to(getattr(torch, dtype))  # 1024 rows, 16 values
    ks, ki = tstream.mips_topk_stream(q, e, 200)
    ps, _ = tstream.mips_topk_stream_plain(q.cpu(), e.cpu(), 200)
    torch.cuda.synchronize()
    assert torch.equal(ks.cpu(), ps)
    assert all(len(set(r)) == 200 for r in ki.tolist())
    assert torch.equal((q @ e.float().T).gather(1, ki.long()), ks)


@pytest.mark.cuda
def test_stream_kernel_refuses_k_above_its_limit(cuda):
    """The lists live in the output rows, so the limit is the source's
    K_MAX, not shared memory; the limit itself runs."""
    lib = tp2._kernel_libs()["mips_stream"]
    limit = tstream.STREAM_K_MAX
    assert lib.mips_stream_k_max() == limit
    emb = torch.zeros((limit + 1, 16), dtype=torch.bfloat16, device=cuda)
    q = torch.ones((1, 16), device=cuda)
    with pytest.raises(ValueError, match=str(limit)):
        tstream.mips_topk_stream(q, emb, limit + 1)
    s, i = tstream.mips_topk_stream(q, emb, limit)
    torch.cuda.synchronize()
    assert len(set(i[0].tolist())) == limit


@pytest.mark.cuda
def test_stream_smem_mirrors_the_library(cuda):
    """``stream_smem`` and ``stream_qpb`` (pure Python) equal what
    ``csrc/mips_stream.cu`` lays out and launches."""
    lib = tp2._kernel_libs()["mips_stream"]
    for planes in (1, 2):
        for k in (1, 100, 175, 176, 239, 240, 1000, 32_768):
            for b in (1, 8, 64, 128, 512):
                assert lib.mips_stream_smem(0, planes, k, b) == \
                    tstream.stream_smem(torch.bfloat16, planes, k, b), (
                        planes, k, b)
    assert lib.mips_stream_smem(1, 1, 100, 8) == tstream.stream_smem(
        torch.float32)
    assert lib.mips_stream_qpb(0) == tstream.stream_qpb(torch.bfloat16)
    assert lib.mips_stream_qpb(1) == tstream.stream_qpb(torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [1, 8, 64, 257, 512])
def test_stream_kernel_batch_sizes(cuda, qdtype, b):
    """B9 at every batch size of the persistent core's query tiles (257 and
    512 end in a partial or full last tile of 128), on a bf16 query (one
    plane) and an f32 one (the hi/lo split into one accumulator)."""
    g = torch.Generator(device=cuda).manual_seed(b + 3)
    emb = _unit(g, (20_000, 1024), cuda).to(torch.bfloat16)
    q = _unit(g, (b, 1024), cuda).to(getattr(torch, qdtype))
    ks, ki = tstream.mips_topk_stream(q, emb, 100)
    torch.cuda.synchronize()
    ps, pi = tstream.mips_topk_stream_plain(q.cpu(), emb.cpu(), 100)
    _assert_topk_close(q, emb, ks, ki, ps, pi, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [1, 8, 64, 257, 512])
def test_dense_kernel_batch_sizes(cuda, qdtype, b):
    """B3 (B6's instance) at every batch size of the persistent core's
    query tiles, valid_n < N and a ragged last tile, on a bf16 query (one
    plane; the plain version widens it exactly) and an f32 one."""
    g = torch.Generator(device=cuda).manual_seed(b + 5)
    n, nv = 20_000 - 37, 19_990 - 37
    emb = _unit(g, (n, 1024), cuda).to(torch.bfloat16)
    q = _unit(g, (b, 1024), cuda).to(getattr(torch, qdtype))
    t = tp2._pool_t(100, nv, 256, 4)
    ks, ki = tp2.scan_topt_dense(q, emb, nv, 256, t)
    ps, pi = tp2.scan_topt_dense_plain(q, emb, nv, 256, t)
    torch.cuda.synchronize()
    assert ks.shape == (-(-n // 256), b, t) and int(ki.max()) < nv
    _assert_dense_close(q.float(), emb, ks, ki, ps, pi, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f16h", "f16"])
@pytest.mark.parametrize("b", [1, 8, 64, 257, 512])
def test_f16_kernel_batch_sizes(cuda, kind, b):
    """B4 and B5 at every batch size of the persistent core's query tiles
    (128 queries a unit for B4, 64 for B5's two accumulators)."""
    g = torch.Generator(device=cuda).manual_seed(b + 7 + len(kind))
    emb, q = _f16_case(g, b, 20_000 - 37, 1024, cuda)
    nv = 19_990 - 37
    _run_f16(kind, q, emb, nv, 256, tp2._pool_t(100, nv, 256, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B6", "B7", "B8"])
@pytest.mark.parametrize("b,n,d,k", [
    (64, 262_144 - 777, 1024, 100),
    (5, 4099, 1024, 100),  # k = 100 above T = 15
])
def test_row_wrappers_on_card_match_cpu(cuda, kernel, b, n, d, k):
    """``mips_topk_dense`` (B6, bf16 rows and a bf16 query),
    ``mips_topk_f16`` (B7) and ``mips_topk_int8`` (B8) on the card return
    the CPU path's top-k and count each launch once, under their own name
    and not under that of the template's scan (B3, B5, B2)."""
    g = torch.Generator(device=cuda).manual_seed(b + n + len(kernel))
    e = _unit(g, (n, d), cuda)
    q = _unit(g, (b, d), cuda)
    if kernel == "B6":
        fn, q = tp2.mips_topk_dense, q.to(torch.bfloat16)
        ops, rtol, ref = (e.to(torch.bfloat16),), 1e-4, e.to(torch.bfloat16)
    elif kernel == "B7":
        fn, ops, rtol = tp2.mips_topk_f16, (e.half(),), 1e-5
        ref = e.half()
    else:
        fn = tp2.mips_topk_int8
        v, s = tp2.quantize_int8(e)
        ops, rtol, ref = (v, s), 1e-5, v.float() * s
    scan = {"B6": tp2.scan_topt_dense, "B7": tp2.scan_topt_f16,
            "B8": tp2.scan_topt_int8}[kernel]
    before = fn.launches, scan.launches
    ks, ki = fn(q, *ops, k)
    torch.cuda.synchronize()
    assert (fn.launches, scan.launches) == (before[0] + 1, before[1])
    ps, pi = fn(q.cpu(), *(o.cpu() for o in ops), k)
    qr = q.float()
    if kernel == "B8":
        qv, qs = tp2.quantize_int8(qr)
        qr = qv.float() * qs
    _assert_topk_close(qr, ref, ks, ki, ps, pi, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B6", "B7", "B8", "B9"])
def test_row_wrappers_refuse_what_they_cannot_take(cuda, kernel):
    """A wrong row dtype, non-contiguous or misaligned rows, and a CPU
    query against rows on the card raise before any launch."""
    n, d = 256, 64
    dtype = {"B6": torch.bfloat16, "B7": torch.float16, "B8": torch.int8,
             "B9": torch.bfloat16}[kernel]
    wrong = {"B6": torch.float16, "B7": torch.bfloat16, "B8": torch.float16,
             "B9": torch.int8}[kernel]
    fn = {"B6": tp2.mips_topk_dense, "B7": tp2.mips_topk_f16,
          "B8": tp2.mips_topk_int8, "B9": tstream.mips_topk_stream}[kernel]
    extra = ((torch.ones((n, 1), device=cuda),) if kernel == "B8" else ())
    q = torch.ones((2, d), device=cuda)
    rows = torch.zeros((n, d), dtype=dtype, device=cuda)
    buf = torch.zeros(n * d + 1, dtype=dtype, device=cuda)
    misaligned = buf[1:].view(n, d)
    assert misaligned.data_ptr() % 16
    before = fn.launches
    with pytest.raises(TypeError):
        fn(q, rows.to(wrong), *extra, 4)
    with pytest.raises(ValueError):
        fn(q, rows.t().contiguous().t(), *extra, 4)
    with pytest.raises(ValueError):
        fn(q, misaligned, *extra, 4)
    with pytest.raises(ValueError):
        fn(q.cpu(), rows, *extra, 4)
    assert fn.launches == before
