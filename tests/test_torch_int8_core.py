"""The host side of the int8 wgmma core (``csrc/topt_int8r2.cu``): kernel
B1's interleaved query plane and the scan geometry's pure mirror, on the
CPU.

The kernel cannot run here, so its arithmetic is emulated on the layout it
reads: int32 sums of each A row (exact, as wgmma's s32 sums are in any
order), the two planes of query q taken from A rows 16 (q // 8) + q % 8 and
that + 8 (what wgmma's fragment layout gives one thread), then the kernel's
f32 combination in its order. That must equal the plain versions
(``scan_topt_int8r2_plain``, ``scan_topt_int8_plain``, which the JAX
parity tests pin to the Pallas kernels) bit for bit: scores, ids and the
-1 slots. The card tests (``test_torch_cuda.py``) hold the kernel itself to
the plain versions."""

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.ops import mips_topt as tp2


def _planes(rng, b, d):
    """Seeded int8 query planes and their f32 scales, as the quantisers
    leave them."""
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return tp2.quantize_int8_residual(q)


@pytest.mark.parametrize("b", [1, 2, 7, 8, 9, 63, 64, 65, 130])
def test_interleave_round_trips(b):
    """Rows 16g..16g+7 are plane 1 of queries 8g..8g+7, rows 16g+8..16g+15
    their plane 2, padded with zero rows to 2 * round_up(b, 8); taking the
    rows back gives both planes, and each (plane, query) sits in the rows r
    and r + 8 of a warp's 16 that one thread holds."""
    rng = np.random.default_rng(b)
    qv1, _, qv2, _ = _planes(rng, b, 48)
    a = tp2.interleave_planes(qv1, qv2)
    b8 = -(-b // 8) * 8
    assert a.shape == (2 * b8, 48) and a.dtype == torch.int8
    assert a.is_contiguous()
    groups = a.view(b8 // 8, 2, 8, 48)
    assert torch.equal(groups[:, 0].reshape(b8, 48)[:b], qv1)
    assert torch.equal(groups[:, 1].reshape(b8, 48)[:b], qv2)
    pad = torch.ones(b8, dtype=torch.bool)
    pad[:b] = False
    assert not groups.permute(0, 2, 1, 3).reshape(b8, 2, 48)[pad].any()
    for row in range(2 * b8):
        q, plane = 8 * (row // 16) + row % 8, (row // 8) % 2
        if q < b:
            assert torch.equal(a[row], (qv1, qv2)[plane][q])


def _emulate(a_rows, q_of, qs1, qs2, emb, es, b, valid_n, tile, t):
    """The kernel's scores on its A plane: exact int32 sums per A row, each
    query's accumulator rows picked by ``q_of``, the f32 combination in the
    kernel's order, then the per-tile top-T of ``_tile_topt_plain``."""
    sums = a_rows.numpy().astype(np.int64) @ emb.numpy().astype(np.int64).T
    assert np.abs(sums).max() < 2 ** 31  # what an s32 accumulator holds
    f = np.float32
    qs1 = qs1.numpy().reshape(-1).astype(f)
    es = es.numpy().reshape(-1).astype(f)
    acc1 = sums[[q_of(q, 0) for q in range(b)]].astype(f)
    s = acc1 * qs1[:, None]
    if qs2 is not None:
        acc2 = sums[[q_of(q, 1) for q in range(b)]].astype(f)
        s = s + acc2 * qs2.numpy().reshape(-1).astype(f)[:, None]
    s = torch.from_numpy((s * es[None, :]).astype(f))
    return tp2._tile_topt_plain(lambda lo, hi: s[:, lo:hi], b, emb.shape[0],
                                valid_n, tile, t, emb.device)


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("b,n,nv,d,k_sel,tile", [
    (2, 1500, 1400, 64, 40, 256),      # the train step's 2 queries
    (9, 777, 700, 80, 50, 128),        # d not a multiple of 128; tile 128
    (65, 1024, 1024, 32, 400, 256),    # a query group past 64
    (5, 4099, 3000, 16, 4096, 256),    # more candidates than valid rows
])
def test_interleaved_emulation_equals_plain(planes, b, n, nv, d, k_sel,
                                            tile):
    """The kernel's arithmetic on its A rows (B1: the interleaved plane;
    B2: the query plane) equals the plain version bit for bit."""
    rng = np.random.default_rng(b + n + d + planes)
    v1, s1, _, _ = tp2.quantize_int8_residual(
        torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)))
    es = s1.reshape(1, -1)
    qv1, qs1, qv2, qs2 = _planes(rng, b, d)
    t = tp2._pool_t(k_sel, nv, tile, 4)
    if planes == 2:
        got = _emulate(tp2.interleave_planes(qv1, qv2),
                       lambda q, p: 16 * (q // 8) + 8 * p + q % 8, qs1, qs2,
                       v1, es, b, nv, tile, t)
        want = tp2.scan_topt_int8r2_plain(qv1, qs1, qv2, qs2, v1, es, nv,
                                          tile, t)
    else:
        got = _emulate(qv1, lambda q, p: q, qs1, None, v1, es, b, nv, tile,
                       t)
        want = tp2.scan_topt_int8_plain(qv1, qs1, v1, es, nv, tile, t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[1] < nv).all())


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("b", [1, 2, 8, 63, 64, 65, 127, 128, 129, 257, 512,
                               1000, 4096])
def test_geometry_invariants(planes, b):
    """The geometry's mirror: a ring of 4 to 8 stages (3 or more beside
    "overlap"'s score tile), as deep as fits the block's shared memory
    beside the row scales' buffers (a stage holds 128 bytes of d, so the
    layout is that of every d), a query box of whole 8-row groups that
    covers the batch's A rows or one tile of 128, query tiles covering
    every A row, the block of the schedule, and the persistent blocks'
    walk (u = block, block + grid, ...) visiting every (query tile, index
    tile) exactly once, also where the grid divides neither the units nor
    the index tiles (132 SMs over odd tile counts)."""
    for n_rows, sms in ((1, 132), (300, 132), (20_000 - 37, 132),
                        (79 * 256 - 5, 132), (131 * 256 + 1, 132),
                        (1_300_000, 132), (4096, 7)):
        g = tp2.int8_scan_geometry(b, planes, n_rows, sms)
        a_rows = b if planes == 1 else 2 * (-(-b // 8) * 8)
        assert g["a_rows"] == a_rows
        assert g["qbox"] % 8 == 0 and g["qbox"] <= tp2.INT8_QROWS
        assert g["qbox"] >= min(a_rows, tp2.INT8_QROWS)
        stage = -(-g["qbox"] * 128 // 1024) * 1024 + 256 * 128
        # "overlap" gives a score tile of 64 rows of 260 f32 the room of a
        # ring stage and more
        tile = 64 * 260 * 4 if g["schedule"] == "overlap" else 0
        assert (3 if tile else 4) <= g["stages"] <= 8
        # barriers, the stages, 4 units' row scales, the score tile,
        # alignment slack
        assert 1024 + g["stages"] * stage + 4 * 1024 + tile + 1024 <= 232_448
        assert 1024 + (g["stages"] + 1) * stage + 4 * 1024 + tile + 1024 > (
            232_448) or g["stages"] == 8
        assert g["q_tiles"] * tp2.INT8_QROWS >= a_rows
        assert (g["q_tiles"] - 1) * tp2.INT8_QROWS < a_rows
        # every query's A rows lie in one query tile
        per_tile = tp2.INT8_QROWS // planes
        assert g["q_tiles"] == -(-b // per_tile)
        # two consumer warpgroups and a producer warp; "overlap": two emit
        # warps beside them
        assert g["threads"] == {"serial": 288, "overlap": 352}[g["schedule"]]
        n_tiles = -(-n_rows // 256)
        assert g["units"] == g["q_tiles"] * n_tiles
        assert g["grid"] == min(g["units"], sms)
        if g["units"] <= 50_000:
            seen = np.zeros((g["q_tiles"], n_tiles), dtype=np.int64)
            for blk in range(g["grid"]):
                u = np.arange(blk, g["units"], g["grid"])
                np.add.at(seen, (u % g["q_tiles"], u // g["q_tiles"]), 1)
            assert (seen == 1).all()


def test_geometry_small_batches_deepen_the_ring():
    """A batch within one tile loads only its own query rows, so the ring
    holds more, shorter stages: B2 6 at B = 2 (8 A rows) and 4 for a full
    tile of 128 A rows; B1, whose overlapped schedule keeps a score tile
    beside the ring, 4 at B = 2 (16 A rows) and 3 for a full tile. B1
    overlaps at every batch, B2 at none."""
    geo = tp2.int8_scan_geometry
    assert geo(2, 1, 10_000, 132)["stages"] == 6
    assert geo(2, 2, 10_000, 132)["stages"] == 4
    assert geo(512, 1, 10_000, 132)["stages"] == 4
    assert geo(512, 2, 10_000, 132)["stages"] == 3
    # B1 packs 64 queries a unit, B2 128
    assert geo(512, 2, 256, 132)["q_tiles"] == 8
    assert geo(512, 1, 256, 132)["q_tiles"] == 4
    for b in (1, 2, 64, 65, 512, 4096):
        assert geo(b, 2, 10_000, 132)["schedule"] == "overlap"
        assert geo(b, 1, 10_000, 132)["schedule"] == "serial"
