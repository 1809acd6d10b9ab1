"""Port parity: the int8r scan-merge-refine, quantisation and the exact
oracle of ``jsa_rag_tpu_torch.ops`` against ``jsa_rag_tpu.ops`` on the same
numpy inputs. The JAX Pallas wrapper runs in interpret mode (its default off
the TPU); the port runs the kernel's plain version, as it does for every CPU
tensor.

Tolerances: int8 codes must be equal and scales within 1 ulp (both
compute amax * f32(1/127) in f32; the ulp allows for a library that
rounds the product differently). Search scores agree to 1e-5: the
coarse plane-1 term is the same f32 arithmetic, and the refine's f32 dot
products are summed in another order by XLA and by torch (relative error
<= d * 2^-24 ~ 1e-5 at d = 128). Ids must be equal wherever the scores
differ by more than that; among tied scores they are compared as sets."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jsa_rag_tpu.ops import mips as jmips
from jsa_rag_tpu.ops import mips_pallas2 as jp2
from jsa_rag_tpu_torch.ops import mips as tmips
from jsa_rag_tpu_torch.ops import mips_topt as tp2

TOL = 1e-5
TILE_N = 256  # the port's emit tile, handed to the JAX wrapper too


def _unit_rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_same_topk(sa, ia, sb, ib, tol=TOL):
    """Scores equal within ``tol``; ids equal except among tied scores."""
    sa, ia, sb, ib = (np.asarray(x) for x in (sa, ia, sb, ib))
    np.testing.assert_allclose(sa, sb, rtol=tol, atol=tol)
    for s1, i1, s2, i2 in ((sa, ia, sb, ib), (sb, ib, sa, ia)):
        for r in range(i1.shape[0]):
            where = {int(i): p for p, i in enumerate(i2[r])}
            for p in np.nonzero(i1[r] != i2[r])[0]:
                i, s = int(i1[r, p]), s1[r, p]
                # moved within the list: it must tie with what it swapped
                # with; missing from the other list: it must tie with the
                # other list's boundary score
                other = s2[r, where[i]] if i in where else s2[r, -1]
                assert abs(other - s) <= tol * (1 + abs(s)), (r, p, i)


def _planes(e):
    """The stored int8r planes of float rows, from the JAX quantiser."""
    v1, s1, v2, s2 = (np.asarray(a) for a in jp2.quantize_int8_residual(
        jnp.asarray(e)))
    return v1, s1.reshape(1, -1), v2, s2.reshape(1, -1)


def _recon(e):
    v1, s1, v2, s2 = _planes(e)
    return (v1.astype(np.float32) * s1.reshape(-1, 1)
            + v2.astype(np.float32) * s2.reshape(-1, 1))


def _both_int8r(q, v1, s1, v2, s2, k, *, valid_n=None, pool_n=None,
                refine=4):
    """Same search through the JAX wrapper and the port, as numpy."""
    js, ji = jp2.mips_topk_pallas2_int8_t(
        jnp.asarray(q), jnp.asarray(v1.T), jnp.asarray(s1), k,
        valid_n=valid_n, pool_n=pool_n, tile_n=TILE_N, refine=refine,
        res_rows=jnp.asarray(v2), res_scale=jnp.asarray(s2),
        int8r_refine="rows")
    ts, ti = tp2.mips_topk_int8r_t(
        _t(q), _t(v1), _t(s1), k, res_rows=_t(v2), res_scale=_t(s2),
        valid_n=valid_n, pool_n=pool_n, tile_n=TILE_N, refine=refine)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


@pytest.mark.parametrize("case", ["gauss", "zero_row", "half_steps"])
def test_quantize_matches_jax(case):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 48)).astype(np.float32) * 3
    if case == "zero_row":  # the 1e-12 scale floor
        x[5] = 0.0
    if case == "half_steps":  # exact .5 quotients: round half to even
        x = (np.arange(64 * 48, dtype=np.float32).reshape(64, 48) % 9
             - 4.5) * np.float32(2.0)
        x[:, 0] = 127.0
    jv, js = (np.asarray(a) for a in jp2.quantize_int8(jnp.asarray(x)))
    tv, ts = tp2.quantize_int8(_t(x))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=1)
    jr = [np.asarray(a) for a in jp2.quantize_int8_residual(jnp.asarray(x))]
    tr = [a.numpy() for a in tp2.quantize_int8_residual(_t(x))]
    for j, t in zip(jr[::2], tr[::2]):
        assert t.dtype == np.int8
        np.testing.assert_array_equal(t, j)
    for j, t in zip(jr[1::2], tr[1::2]):
        np.testing.assert_array_max_ulp(t, j, maxulp=1)


def test_pool_t_and_round_up_match_jax():
    for k, n, tile, t in ((400, 4099, 256, 4), (512, 1300000, 256, 4),
                          (4099, 4099, 256, 4), (40, 100, 128, 4),
                          (100, 1232, 256, 4)):
        assert tp2._pool_t(k, n, tile, t) == jp2._pool_t(k, n, tile, t)
    for x, m in ((1, 128), (4099, 256), (2048, 2048)):
        assert tp2._round_up(x, m) == jp2._round_up(x, m)


@pytest.mark.parametrize("n,d,b,k", [(1500, 128, 16, 10), (700, 64, 5, 40),
                                     (100, 32, 3, 7)])
def test_int8r_topk_matches_jax(n, d, b, k):
    """The port's scan-merge-refine returns the JAX wrapper's results, at
    tile 256 (n=1500, 700) and at the clamped tile 128 (n=100)."""
    rng = np.random.default_rng(n)
    e = _unit_rows(n, d, seed=n)
    gold = rng.integers(0, n, b)
    q = e[gold] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    (js, ji), (ts, ti) = _both_int8r(q, *_planes(e), k)
    assert_same_topk(ts, ti, js, ji)
    assert (ti[:, 0] == gold).all()


def test_int8r_scores_match_reconstruction_oracle():
    """``test_int8r.py::test_int8r_kernel_matches_reconstruction_oracle``,
    rows strategy: scores are q . (v1*s1 + v2*s2) up to the third-order
    query-quantisation term (atol 1e-4 on unit scores), gold top-1 holds."""
    n, d, k = 1500, 128, 10
    rng = np.random.default_rng(5)
    e = _unit_rows(n, d, seed=5)
    gold = rng.integers(0, n, 16)
    q = e[gold] + 0.01 * rng.standard_normal((16, d)).astype(np.float32)
    v1, s1, v2, s2 = _planes(e)
    oracle = q @ _recon(e).T
    oi = np.argsort(-oracle, axis=1, kind="stable")[:, :k]
    s, i = tp2.mips_topk_int8r_t(_t(q), _t(v1), _t(s1), k, res_rows=_t(v2),
                                 res_scale=_t(s2), refine=6)
    s, i = s.numpy(), i.numpy()
    np.testing.assert_allclose(s, np.take_along_axis(oracle, i, axis=1),
                               rtol=1e-5, atol=1e-4)
    assert (i[:, 0] == gold).all()
    recall = np.mean([len(set(i[r]) & set(oi[r])) / k for r in range(16)])
    assert recall >= 0.9, recall


def test_valid_n_masks_tail():
    """``test_mips.py::test_transposed_valid_n_masks_tail``: rows past the
    runtime valid count (here huge garbage) never come back, and the result
    equals the JAX wrapper's over the same padded planes."""
    rng = np.random.default_rng(5)
    n, n_alloc, d, k = 300, 512, 32, 10
    e = _unit_rows(n, d, seed=5)
    pad = np.full((n_alloc, d), 100.0, np.float32)
    pad[:n] = e
    v1, s1, v2, s2 = _planes(pad)
    q = rng.standard_normal((6, d)).astype(np.float32)
    (js, ji), (ts, ti) = _both_int8r(q, v1, s1, v2, s2, k, valid_n=n)
    assert ti.max() < n and ti.min() >= 0
    assert_same_topk(ts, ti, js, ji)
    oracle = q @ _recon(e).T
    np.testing.assert_allclose(
        ts, -np.sort(-oracle, axis=1)[:, :k], rtol=1e-5, atol=1e-4)


def test_no_duplicate_ids_when_pool_exceeds_valid():
    """``test_mips.py::test_f16_refine_no_duplicate_ids_when_pool_exceeds_
    valid`` for int8r: refine*k (400) exceeds the 104 valid rows, so
    exhausted tile slots emit -1; they must never surface as a passage."""
    rng = np.random.default_rng(61)
    b, n_valid, n_alloc, d, k = 4, 104, 128, 32, 100
    e = np.zeros((n_alloc, d), np.float32)
    e[:n_valid] = _unit_rows(n_valid, d, seed=61)
    q = rng.standard_normal((b, d)).astype(np.float32)
    (js, ji), (ts, ti) = _both_int8r(q, *_planes(e), k, valid_n=n_valid,
                                     pool_n=n_valid)
    oi = np.argsort(-(q @ _recon(e[:n_valid]).T), axis=1)[:, :k]
    for row in range(b):
        assert len(set(ti[row])) == k and ti[row].min() >= 0
        assert set(ti[row]) == set(oi[row])
    assert_same_topk(ts, ti, js, ji)


def test_pool_not_starved():
    """``_pool_t``'s regressions. n=4099, k=100: the last tile holds 3
    rows and a ceil-sized pool lost the tail; the pool must keep recall.
    A mostly padded index (``test_flat_index.py::test_transposed_pad_
    starved_shard_keeps_topk``): 1232 valid rows in 8192 allocated, the
    top-120 planted in the first tile; pool sizing from the valid count
    (pool_n) keeps every true top-k hit."""
    rng = np.random.default_rng(9)
    n, d, k = 4099, 64, 100
    e = _unit_rows(n, d, seed=9)
    q = _unit_rows(2, d, seed=10)
    (js, ji), (ts, ti) = _both_int8r(q, *_planes(e), k)
    assert_same_topk(ts, ti, js, ji)
    oi = np.argsort(-(q @ _recon(e).T), axis=1)[:, :k]
    assert min(len(set(ti[r]) & set(oi[r])) for r in range(2)) >= 99

    n_valid, n_alloc = 1232, 8192
    e = np.zeros((n_alloc, d), np.float32)
    e[:n_valid] = _unit_rows(n_valid, d, seed=11)
    q = _unit_rows(1, d, seed=12)
    plant = np.arange(120)
    e[plant] = q[0] + 0.03 * rng.standard_normal((120, d))
    e[plant] /= np.linalg.norm(e[plant], axis=1, keepdims=True)
    (js, ji), (ts, ti) = _both_int8r(q, *_planes(e), k, valid_n=n_valid,
                                     pool_n=n_valid)
    want = set(np.argsort(-(_recon(e[:n_valid]) @ q[0]))[:k].tolist())
    assert not want - set(ti[0].tolist())
    assert_same_topk(ts, ti, js, ji)


def test_scan_plain_emits_first_column_on_ties():
    """The plain scan's per-tile emit is T first-occurrence extract-max
    passes (``_emit_topt``): equal scores come out in column order, masked
    columns as (NEG_INF, -1)."""
    d, tile = 16, 128
    e = np.zeros((200, d), np.int8)
    e[:, 0] = 1  # every row scores the same
    qv = np.zeros((1, d), np.int8)
    qv[0, 0] = 1
    one = torch.ones((1, 1))
    s, i = tp2.scan_topt_int8r2_plain(
        _t(qv), one, _t(qv), one, _t(e), torch.ones((1, 200)), 150, tile, 4)
    assert s.shape == (2, 1, 4) and i.dtype == torch.int32
    assert i[0, 0].tolist() == [0, 1, 2, 3]
    assert i[1, 0].tolist() == [128, 129, 130, 131]
    s, i = tp2.scan_topt_int8r2_plain(
        _t(qv), one, _t(qv), one, _t(e), torch.ones((1, 200)), 130, tile,
        4)
    assert i[1, 0].tolist() == [128, 129, -1, -1]
    assert s[1, 0, 2].item() == tp2.NEG_INF


def test_exact_oracle_matches_jax():
    """``mips_topk_exact`` over rows and ``mips_topk_xla_t`` over a (d, N)
    index with a valid count, chunked, against the JAX oracle."""
    rng = np.random.default_rng(3)
    n, n_alloc, d, k = 1000, 1024, 32, 17
    e = rng.standard_normal((n, d)).astype(np.float32)
    et = np.zeros((d, n_alloc), np.float32)
    et[:, :n] = e.T
    et[:, n:] = 100.0
    q = rng.standard_normal((5, d)).astype(np.float32)
    js, ji = jmips.mips_topk_exact(jnp.asarray(q), jnp.asarray(e), k,
                                   chunk=256)
    ts, ti = tmips.mips_topk_exact(_t(q), _t(e), k, chunk=256)
    assert_same_topk(ts.numpy(), ti.numpy(), js, ji)
    js, ji = jmips.mips_topk_xla_t(jnp.asarray(q), jnp.asarray(et), k,
                                   chunk=300, valid_n=n)
    ts, ti = tmips.mips_topk_xla_t(_t(q), _t(et), k, chunk=300, valid_n=n)
    assert ti.max().item() < n
    assert_same_topk(ts.numpy(), ti.numpy(), js, ji)
