"""Port parity: the row-major searches of ``jsa_rag_tpu_torch`` — kernel
B9's exact streaming top-k (``mips_stream.mips_topk_stream``), the
row-major wrappers of kernels B6, B7 and B8 (``mips_topt.mips_topk_dense``,
``mips_topk_f16``, ``mips_topk_int8``) and the dispatcher
``mips.mips_topk`` — against the JAX package on the same numpy inputs. The
JAX kernels run in Pallas interpret mode, as ``tests/test_mips.py`` runs
them; the port runs each kernel's plain version, as it does for every CPU
tensor.

Tolerances, each with its reason:
- B9 (exact top-k): scores to 1e-4 relative and absolute, the bound of
  ``test_mips.py::test_pallas_matches_oracle`` (both sides multiply in f32
  and sum in another order); the returned ids' own oracle scores to the
  same bound; ids distinct, also under ties.
- B6 (per-tile top-T, both sides pooling the same 256-row tiles with the
  same T): scores to 1e-5 (f32 sums in another order), ids equal where the
  scores are distinct; at k > T the id sets are equal.
- B7: the JAX kernel keeps ~16 bits of the query (three bf16 passes), the
  port's ~22 (two fp16 planes; on the CPU its plain version is the f32
  product), so each side is held to the exact-fp16 oracle instead: the
  port to 1e-5·|q|·|x|, the JAX package to ``test_mips.py:136``'s 2e-3,
  and the port's ids equal to the oracle's where k <= T.
- B8: int8 codes equal bit for bit; both sides then compute
  ``(acc * qs) * es`` in f32 from the same codes, so scores agree to
  1e-6·|q|·|x| (the dequantised norms) and ids are equal.
- ``mips_topk``: every method against the JAX dispatcher at 1e-5 (f32 and
  bf16 rows), fp16 rows at the JAX fp16 kernel's 2e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.ops import mips as jmips
from jsa_rag_tpu.ops import mips_pallas2 as jp2
from jsa_rag_tpu.ops.mips_pallas import mips_topk_pallas
from jsa_rag_tpu_torch.ops import mips as tmips
from jsa_rag_tpu_torch.ops import mips_stream as tstream
from jsa_rag_tpu_torch.ops import mips_topt as tp2

from test_torch_mips import _t, _unit_rows, assert_same_topk


def _data(b, n, d, seed):
    """``test_mips.py::make_data``: gaussian queries and rows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _oracle(q, e, k):
    s = q @ e.T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx, s


def _bf16(a):
    """numpy f32 -> its bf16 rounding as f32 (both packages round to
    nearest even)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---------------------------------------------------------------- B9
@pytest.mark.parametrize("b,n,d,k", [
    (4, 300, 64, 10),
    (16, 2048, 128, 100),
    (3, 1500, 256, 128),
    (1, 129, 128, 7),
])
def test_stream_matches_jax_pallas(b, n, d, k):
    """``mips_topk_stream`` against ``mips_topk_pallas`` at the shapes and
    tiles of ``test_pallas_matches_oracle``, and both against the oracle."""
    q, e = _data(b, n, d, seed=b + n)
    js, ji = mips_topk_pallas(jnp.array(q), jnp.array(e), k, tile_q=8,
                              tile_n=128, interpret=True)
    ts, ti = tstream.mips_topk_stream(_t(q), _t(e), k)
    assert ts.shape == (b, k) and ti.dtype == torch.int32
    ov, _, s = _oracle(q, e, k)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), ov, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.take_along_axis(s, ti.numpy(), axis=1),
                               ov, rtol=1e-4, atol=1e-4)
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=1e-4)
    assert all(len(set(r)) == k for r in ti.tolist())


def test_stream_bf16_rows_match_jax_pallas():
    """bf16 rows and a bf16 query (the bench's ``pallas`` method): both
    sides score exact bf16 x bf16 products in f32."""
    q, e = _data(5, 700, 64, seed=3)
    qb, eb = _bf16(q), _bf16(e)
    js, ji = mips_topk_pallas(jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(e, jnp.bfloat16), 20, tile_q=8,
                              tile_n=128, interpret=True)
    ts, ti = tstream.mips_topk_stream(_t(q).to(torch.bfloat16),
                                      _t(e).to(torch.bfloat16), 20)
    ov, _, _ = _oracle(qb, eb, 20)
    np.testing.assert_allclose(ts.numpy(), ov, rtol=1e-4, atol=1e-4)
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=1e-4)


def test_stream_duplicate_scores():
    """``test_pallas_duplicate_scores``: 128 rows whose scores repeat 8x;
    the score multisets equal the JAX kernel's and the oracle's, and the
    ids are distinct."""
    q = np.ones((4, 32), np.float32)
    e = np.tile(np.repeat(np.arange(16, dtype=np.float32)[:, None], 32,
                          axis=1), (8, 1))
    js, _ = mips_topk_pallas(jnp.array(q), jnp.array(e), 20, tile_q=8,
                             tile_n=64, interpret=True)
    ts, ti = tstream.mips_topk_stream(_t(q), _t(e), 20)
    ov, _, s = _oracle(q, e, 20)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), ov, rtol=1e-5)
    np.testing.assert_allclose(np.take_along_axis(s, ti.numpy(), axis=1),
                               ov, rtol=1e-5)
    for row in ti.tolist():
        assert len(set(row)) == len(row)


def test_stream_k_above_n_and_geometry():
    """k = min(k, n), every row once; the kernel's geometry: 128 queries a
    block on bf16 rows (32 on f32 rows), shared memory that no longer grows
    with k, slices that fill the SMs once, and a k above the limit
    refused."""
    q, e = _data(2, 50, 16, seed=4)
    ts, ti = tstream.mips_topk_stream(_t(q), _t(e), 80)
    assert ts.shape == (2, 50)
    assert all(sorted(r) == list(range(50)) for r in ti.tolist())

    bf, f32 = torch.bfloat16, torch.float32
    # csrc/mips_stream.cu's layout (the card tests compare with the
    # library's mips_stream_smem): 4 stages of 48 KB, or 3 of 64 KB with
    # two planes, barriers, row buffers, row state, alignment slack
    # the scores of the lists of k slots of min(b, 128) queries in shared
    # memory where a ring of two stages still fits beside them (the ring
    # then takes what is left, at most 8 stages), else in the output beside
    # 4 stages of 48 KB (3 of 64 KB with two planes)
    fixed = 1024 + 8192 + 1536 + 1024
    assert tstream.stream_smem(bf, 1, 100, 512) == (fixed + 3 * 49_152
                                                    + 128 * 100 * 4)
    assert tstream.stream_smem(bf, 1, 100, 8) == (fixed + 4 * 49_152
                                                  + 8 * 100 * 4)
    assert tstream.stream_smem(bf, 1, 239, 512) == 232_448
    assert tstream.stream_smem(bf, 1, 240, 512) == fixed + 4 * 49_152
    assert tstream.stream_smem(bf, 2, 200, 512) == fixed + 3 * 65_536
    assert tstream.stream_smem(bf, 2, 160, 512) == (fixed + 2 * 65_536
                                                    + 128 * 160 * 4)
    assert tstream.stream_smem(f32) == 37_120 + 384
    assert max(tstream.stream_smem(bf, p, k, b) for p in (1, 2)
               for k in (1, 100, 175, 176, 239, 240, 32_768)
               for b in (1, 8, 64, 128, 512)) <= 232_448

    def geo(b, n, k, dtype, planes=1):
        return tstream.stream_geometry(
            b, n, k, tstream.stream_qpb(dtype),
            tstream.stream_smem(dtype, planes, k, b), 132)

    assert geo(512, 1_300_000, 100, bf) == (128, 33, 154)
    assert geo(8, 1_300_000, 100, bf) == (128, 131, 39)
    assert geo(512, 1_300_000, 100, bf, 2) == geo(512, 1_300_000, 100, bf)
    # the query order: within each tile of 128, query i at 16 * (i % 8) +
    # i // 8, so eight consecutive queries fall on eight warps of 16 rows
    for b in (1, 8, 128, 130):
        src = tstream.stream_rows(b, "cpu")
        assert src.shape == (-(-b // 128) * 128,)
        assert sorted(src[src >= 0].tolist()) == list(range(b))
        pos = {int(r): p for p, r in enumerate(src.tolist()) if r >= 0}
        assert len({pos[i] // 16 for i in range(min(b, 8))}) == min(b, 8)
        assert all(pos[i] // 128 == i // 128 for i in range(b))
    qpb, slices, tps = geo(5, 4099, 1000, f32)
    assert qpb == 32 and slices * tps >= 17 and slices == 17
    qpb, slices, tps = geo(64, 262_144 - 777, 100, bf)
    assert slices <= 132 and (slices - 1) * tps < 1024 <= slices * tps
    limit = tstream.STREAM_K_MAX
    assert limit == 32_768 and geo(1, 10 ** 6, limit, bf)[0] == 128
    for dtype in (bf, f32):
        with pytest.raises(ValueError, match=str(limit)):
            geo(1, 10 ** 6, limit + 1, dtype)
    # pure functions of their arguments: the same answer twice, none
    # depending on k below the limit
    assert geo(3, 5000, 7, bf) == geo(3, 5000, 7, bf) == geo(3, 5000, 700,
                                                             bf)


def test_bf16_query_takes_one_plane_by_dtype():
    """The one-plane rule of the 16-bit kernels: against bf16 rows a bf16
    query is its own single plane and an f32 one its (hi, lo) split,
    chosen by dtype alone (``bf16_query_planes``, ``dense_query``); the
    plain versions score a bf16 query as its exact f32 widening, so the
    bf16 and the widened query give the same scores and ids (B3, B6,
    B9)."""
    q, e = _data(5, 600, 64, seed=11)
    qb, rows = _t(q).to(torch.bfloat16), _t(e).to(torch.bfloat16)
    (plane,) = tp2.bf16_query_planes(qb)
    assert plane is qb
    hi, lo = tp2.bf16_query_planes(qb.float())
    assert torch.equal(hi, qb) and not bool(lo.any())  # a zero lo plane
    assert tp2.dense_query(qb, rows).dtype == torch.bfloat16
    assert tp2.dense_query(qb, rows.float()).dtype == torch.float32
    assert tp2.dense_query(qb.float(), rows).dtype == torch.float32
    for a, b in zip(tp2.scan_topt_dense_plain(qb, rows, 590, 256, 8),
                    tp2.scan_topt_dense_plain(qb.float(), rows, 590, 256, 8)):
        assert torch.equal(a, b)
    for fn in (tp2.mips_topk_dense, tstream.mips_topk_stream,
               lambda q_, r_, k_: tp2.mips_topk_dense_t(q_, r_, k_,
                                                        valid_n=590)):
        for a, b in zip(fn(qb, rows, 50), fn(qb.float(), rows, 50)):
            assert torch.equal(a, b)
    with pytest.raises(TypeError, match="bfloat16"):
        tp2.scan_topt_dense_plain(qb, rows.float(), 600, 256, 8)


# ---------------------------------------------------------------- B6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,b,k", [(1500, 64, 8, 10), (600, 32, 5, 50)])
def test_dense_rows_match_jax_pallas2(dtype, n, d, b, k):
    """``mips_topk_dense`` against ``mips_topk_pallas2`` with the same
    tiles and T (256, 4): f32 rows with the f32 query, or bf16 rows with a
    bf16-cast query. (600, 50) has k = 50 above T = 41: the id sets are
    equal."""
    q, e = _data(b, n, d, seed=n + d)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    if dtype == "bfloat16":
        jq, je = jnp.asarray(q, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16)
        tq, te = (_t(x).to(torch.bfloat16) for x in (q, e))
    else:
        jq, je, tq, te = jnp.asarray(q), jnp.asarray(e), _t(q), _t(e)
    js, ji = jp2.mips_topk_pallas2(jq, je, k, tile_n=256, t_per_tile=4,
                                   interpret=True)
    ts, ti = tp2.mips_topk_dense(tq, te, k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    t = tp2._pool_t(k, n, 256, 4)
    if k <= t:
        assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js),
                         np.asarray(ji))
    else:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)
        for a, bb in zip(ti.tolist(), np.asarray(ji).tolist()):
            assert set(a) == set(bb)


# ---------------------------------------------------------------- B7
@pytest.mark.parametrize("n,d,b,k", [(1000, 64, 4, 10), (700, 128, 6, 8)])
def test_f16_rows_match_fp16_oracle_and_jax(n, d, b, k):
    """``mips_topk_f16`` over ``torch.float16`` rows and
    ``mips_topk_pallas2_f16`` over ``f16_to_bits`` of the same numpy fp16
    rows, each held to the exact-fp16 oracle at its own precision."""
    q, e = _data(b, n, d, seed=n + 7)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e16 = e.astype(np.float16)
    ov, oi, s = _oracle(q, e16.astype(np.float32), k)
    js, _ = jp2.mips_topk_pallas2_f16(jnp.asarray(q),
                                      jp2.f16_to_bits(jnp.asarray(e16)), k,
                                      tile_n=256, interpret=True)
    np.testing.assert_allclose(np.asarray(js), ov, rtol=2e-3, atol=2e-3)
    ts, ti = tp2.mips_topk_f16(_t(q), torch.from_numpy(e16), k)
    assert k <= tp2._pool_t(k, n, 256, 4)
    tol = 1e-5 * np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(
        e16.astype(np.float32), axis=1)[ti.numpy()]
    assert (np.abs(ts.numpy() - ov) <= tol).all()
    assert_same_topk(ts.numpy(), ti.numpy(), ov, oi, tol=float(tol.max()))


# ---------------------------------------------------------------- B8
@pytest.mark.parametrize("n,d,b,k", [(1000, 64, 4, 10), (2300, 32, 7, 30)])
def test_int8_rows_match_jax(n, d, b, k):
    """``mips_topk_int8`` against ``mips_topk_pallas2_int8`` on the codes
    and scales of the same rows (tile 256, T 4 on both sides)."""
    q, e = _data(b, n, d, seed=n + 11)
    jv, js_ = jp2.quantize_int8(jnp.asarray(e))
    tv, ts_ = tp2.quantize_int8(_t(e))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    js, ji = jp2.mips_topk_pallas2_int8(jnp.asarray(q), jv, js_, k,
                                        tile_n=256, interpret=True)
    ts, ti = tp2.mips_topk_int8(_t(q), tv, ts_, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    qv, qs = tp2.quantize_int8(_t(q))
    qn = (qv.float() * qs).norm(dim=1).numpy()[:, None]
    xn = ((tv.float() * ts_).norm(dim=1).numpy())[ti.numpy()]
    assert (np.abs(ts.numpy() - np.asarray(js)) <= 1e-6 * qn * xn).all()


# --------------------------------------------------------- mips_topk
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("method", ["auto", "exact", "pallas", "pallas2"])
def test_mips_topk_matches_jax_dispatcher(storage, method):
    """Every method of the port's ``mips_topk`` against the JAX
    dispatcher on the same rows (fp16 as int16 bits on the JAX side)."""
    q, e = _data(6, 1000, 64, seed=21)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    k, tol = 10, 1e-5
    if storage == "float16":
        e16 = e.astype(np.float16)
        je, te = jp2.f16_to_bits(jnp.asarray(e16)), torch.from_numpy(e16)
        if method != "exact":
            tol = 2e-3  # the JAX fp16 kernel's three bf16 passes
    elif storage == "bfloat16":
        je, te = jnp.asarray(e, jnp.bfloat16), _t(e).to(torch.bfloat16)
    else:
        je, te = jnp.asarray(e), _t(e)
    js, ji = jmips.mips_topk(jnp.asarray(q), je, k, method=method)
    ts, ti = tmips.mips_topk(_t(q), te, k, method=method)
    assert ts.shape == (6, k) and ti.dtype == torch.int32
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=tol)


def test_mips_topk_dispatch_rules():
    """Which wrapper each method reaches on the CPU: fp16 rows take B7's
    plain version under auto/pallas/pallas2 and the f32 scan under exact;
    bf16/f32 rows take B9's under pallas, B6's under pallas2 and the exact
    scan under auto; approx raises naming the ROADMAP item; int16 bits are
    refused."""
    e = torch.from_numpy(_unit_rows(300, 16, seed=2))
    q = e[:3].clone()
    spies = {}
    names = ("scan_topt_f16_plain", "scan_topt_dense_plain")
    real = {n: getattr(tp2, n) for n in names}
    real_stream = tstream.mips_topk_stream_plain

    def spy(name, fn):
        def wrapper(*a, **kw):
            spies[name] = spies.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    try:
        for n in names:
            setattr(tp2, n, spy(n, real[n]))
        tstream.mips_topk_stream_plain = spy("stream", real_stream)
        expect = [(e.half(), "auto", "scan_topt_f16_plain"),
                  (e.half(), "pallas", "scan_topt_f16_plain"),
                  (e.half(), "pallas2", "scan_topt_f16_plain"),
                  (e.half(), "exact", None),
                  (e, "pallas", "stream"),
                  (e, "pallas2", "scan_topt_dense_plain"),
                  (e.bfloat16(), "pallas2", "scan_topt_dense_plain"),
                  (e, "auto", None), (e, "exact", None)]
        for rows, method, hit in expect:
            spies.clear()
            _, i = tmips.mips_topk(q, rows, 3, method=method)
            assert i[:, 0].tolist() == [0, 1, 2]
            assert list(spies) == ([hit] if hit else []), (method, spies)
    finally:
        for n in names:
            setattr(tp2, n, real[n])
        tstream.mips_topk_stream_plain = real_stream
    for rows in (e, e.half()):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
            tmips.mips_topk(q, rows, 3, method="approx")
    with pytest.raises(TypeError, match="int16"):
        tmips.mips_topk(q, e.half().view(torch.int16), 3)
    with pytest.raises(ValueError, match="unknown"):
        tmips.mips_topk(q, e, 3, method="faiss")


def test_row_wrappers_refuse_what_they_cannot_take():
    q = torch.zeros((2, 16))
    e = torch.zeros((64, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tstream.mips_topk_stream(q, e.to(torch.int8), 4)
    with pytest.raises(TypeError):
        tstream.mips_topk_stream(q.to(torch.int32), e, 4)
    with pytest.raises(ValueError):
        tstream.mips_topk_stream(q, e.t().contiguous().t(), 4)
    with pytest.raises(ValueError):
        tstream.mips_topk_stream(q[:, :8], e, 4)
    with pytest.raises(TypeError):
        tp2.mips_topk_dense(q, e.half(), 4)
    with pytest.raises(TypeError):
        tp2.mips_topk_f16(q, e, 4)
    with pytest.raises(ValueError):
        tp2.mips_topk_int8(q, e.to(torch.int8), torch.ones((63, 1)), 4)
