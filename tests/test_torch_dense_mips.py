"""Port parity: kernel B3's plain version and the dense (bf16 / f32) search
of ``jsa_rag_tpu_torch`` against ``mips_topk_pallas2_t`` of the JAX package
(Pallas in interpret mode, its default off the TPU) and the exact oracle,
on the same numpy inputs. The port's emit tile is 256 against the JAX
wrapper's 2048, so the per-tile candidate lists differ: the final top-k is
compared.

Tolerances: both sides multiply the f32 query by the stored rows in f32 and
sum in another order, so scores agree to 1e-5 (relative and absolute, unit
rows); ids are equal except among scores tied within that tolerance
(``test_torch_mips.assert_same_topk``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.ops import mips_pallas2 as jp2
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TorchIndex
from jsa_rag_tpu_torch.ops import mips as tmips
from jsa_rag_tpu_torch.ops import mips_topt as tp2

from test_torch_mips import _t, _unit_rows, assert_same_topk

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _stored(e, dtype):
    """Rows as each package stores them: (jax (d, N), torch (N, d))."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(e, jdt).T, torch.from_numpy(e).to(tdt)


def _as_f32(e, dtype):
    return np.asarray(jnp.asarray(e, DTYPES[dtype][0]).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d,b,k", [(1500, 64, 8, 10), (700, 32, 5, 40),
                                     (100, 16, 3, 7)])
def test_dense_topk_matches_jax(dtype, n, d, b, k):
    """``mips_topk_dense_t`` (plain scan on the CPU) returns the JAX
    wrapper's top-k, tile 256 and the clamped tile 128 (n=100)."""
    rng = np.random.default_rng(n + d)
    e = _unit_rows(n, d, seed=n)
    gold = rng.integers(0, n, b)
    q = e[gold] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    et, er = _stored(e, dtype)
    js, ji = jp2.mips_topk_pallas2_t(jnp.asarray(q), et, k)
    ts, ti = tp2.mips_topk_dense_t(_t(q), er, k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji))
    assert (ti[:, 0].numpy() == gold).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_valid_n_masks_tail(dtype):
    """``test_mips.py::test_transposed_valid_n_masks_tail``: rows past the
    runtime valid count (huge garbage here) never come back; the plain scan,
    the dense top-k and ``mips_topk_t``'s exact and pallas2 methods all
    equal the unpadded oracle and the JAX wrapper."""
    rng = np.random.default_rng(5)
    n, n_alloc, d, k = 300, 512, 32, 10
    e = rng.standard_normal((n, d)).astype(np.float32)
    pad = np.full((n_alloc, d), 100.0, np.float32)
    pad[:n] = e
    q = rng.standard_normal((6, d)).astype(np.float32)
    ef = _as_f32(e, dtype)
    oracle = -np.sort(-(q @ ef.T), axis=1)[:, :k]
    et, er = _stored(pad, dtype)
    js, ji = jp2.mips_topk_pallas2_t(jnp.asarray(q), et, k, valid_n=n)
    for method in ("exact", "pallas2", "pallas"):
        ts, ti = tmips.mips_topk_t(_t(q), er, k, method=method, valid_n=n)
        assert ti.max().item() < n and ti.min().item() >= 0
        np.testing.assert_allclose(ts.numpy(), oracle, rtol=1e-5,
                                   atol=1e-5)
        assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js),
                         np.asarray(ji))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_no_placeholder_ids_when_pool_exceeds_valid(dtype):
    """The -1 sentinel regression (``test_mips.py::test_f16_refine_no_
    duplicate_ids_when_pool_exceeds_valid``): with k close to the 104 valid
    rows of 128, exhausted tile slots emit (NEG_INF, -1) and never surface
    as a passage; the valid ids come back whole and once each, with
    their oracle scores."""
    rng = np.random.default_rng(61)
    b, n_valid, n_alloc, d, k = 4, 104, 128, 32, 100
    e = np.zeros((n_alloc, d), np.float32)
    e[:n_valid] = _unit_rows(n_valid, d, seed=61)
    q = rng.standard_normal((b, d)).astype(np.float32)
    ts, ti = tp2.mips_topk_dense_t(_t(q), _stored(e, dtype)[1], k,
                                   valid_n=n_valid, pool_n=n_valid)
    s = q @ _as_f32(e[:n_valid], dtype).T
    oi = np.argsort(-s, axis=1)[:, :k]
    for row in range(b):
        assert len(set(ti[row].tolist())) == k and ti[row].min() >= 0
        assert set(ti[row].tolist()) == set(oi[row])
    np.testing.assert_allclose(
        ts.numpy(), np.take_along_axis(s, ti.numpy(), axis=1), rtol=1e-5,
        atol=1e-5)
    # the plain scan itself: a 128-row tile with 104 valid rows and T=128
    cs, ci = tp2.scan_topt_dense_plain(_t(q), _stored(e, dtype)[1],
                                       n_valid, 128, 128)
    assert (ci[0, :, n_valid:] == -1).all()
    assert (cs[0, :, n_valid:] == tp2.NEG_INF).all()


def test_pad_starved_index_keeps_topk():
    """``test_flat_index.py::test_transposed_pad_starved_shard_keeps_topk``:
    a mostly padded index packs its valid rows into few tiles, and the
    per-tile pool is sized from the valid count (pool_n), so every true
    top-k hit planted there survives: through the wrapper (1232 valid of
    8192 rows: 25 hits per valid tile against a pool of 41, where sizing
    from the 32 allocated tiles would give 10) and through the port's bf16
    index (2100 valid of 4096)."""
    d, k = 64, 100
    rng = np.random.default_rng(9)
    q = _unit_rows(1, d, seed=10)

    def planted(n, where):
        e = _unit_rows(n, d, seed=n)
        e[where] = q[0] + 0.03 * rng.standard_normal((len(where), d))
        e[where] /= np.linalg.norm(e[where], axis=1, keepdims=True)
        return e

    def top(e):
        return set(np.argsort(-(_as_f32(e, "bfloat16") @ q[0]))[:k].tolist())

    e = planted(1232, np.linspace(0, 1231, 120).astype(int))
    pad = np.zeros((8192, d), np.float32)
    pad[:1232] = e
    _, ids = tp2.mips_topk_dense_t(_t(q), _stored(pad, "bfloat16")[1], k,
                                   valid_n=1232, pool_n=1232)
    assert not top(e) - set(ids[0].tolist())

    e = planted(2100, np.linspace(0, 2099, 120).astype(int))
    idx = TorchIndex(2100, d, "bfloat16", device="cpu", method="pallas2")
    assert idx.shard_rows == 4096  # tile-aligned over-allocation
    idx.set_embeddings(0, e)
    _, ids = idx.search(q, k)
    assert not top(e) - set(ids[0].tolist())


def test_plain_scan_emits_first_column_on_ties():
    """Equal scores come out in column order per tile; masked columns as
    (NEG_INF, -1)."""
    e = np.zeros((200, 16), np.float32)
    e[:, 0] = 1.0
    q = np.zeros((1, 16), np.float32)
    q[0, 0] = 1.0
    for dtype in DTYPES:
        er = _stored(e, dtype)[1]
        s, i = tp2.scan_topt_dense_plain(_t(q), er, 150, 128, 4)
        assert s.shape == (2, 1, 4) and i.dtype == torch.int32
        assert i[0, 0].tolist() == [0, 1, 2, 3]
        assert i[1, 0].tolist() == [128, 129, 130, 131]
        s, i = tp2.scan_topt_dense_plain(_t(q), er, 130, 128, 4)
        assert i[1, 0].tolist() == [128, 129, -1, -1]
        assert s[1, 0, 2].item() == tp2.NEG_INF


def test_auto_dispatch_rule():
    """``"auto"``: the fused scan on CUDA from 16384 rows (the card's
    crossover against the exact scan), exact otherwise (the JAX package's
    rule, ``mips.py:253-255``, sets its own threshold for a TPU); on the CPU
    the plain scan never runs under auto, and ``pallas2`` runs it; fp16
    rows take the exact scan under auto on the CPU; ``approx`` returns the
    exact scan's ids (its per-chunk selection is exact off the TPU)."""
    assert tmips.AUTO_FUSED_MIN_ROWS == 16384
    assert tmips.auto_method("cuda", 16384) == "pallas2"
    assert tmips.auto_method("cuda", 65536) == "pallas2"
    assert tmips.auto_method("cuda", 16383) == "exact"
    assert tmips.auto_method("cpu", 10 ** 7) == "exact"
    e = torch.from_numpy(_unit_rows(70_000, 16, seed=1))
    q = e[:2].clone()
    calls = []
    real = tp2.scan_topt_dense_plain

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    tp2.scan_topt_dense_plain = spy
    try:
        _, i = tmips.mips_topk_t(q, e, 3)
        assert not calls and i[:, 0].tolist() == [0, 1]
        _, i = tmips.mips_topk_t(q, e, 3, method="pallas2")
        assert calls and i[:, 0].tolist() == [0, 1]
    finally:
        tp2.scan_topt_dense_plain = real
    # fp16 rows: "auto" on the CPU is the exact scan, "pallas2" the coarse
    # scan (B4's plain version) and the f32 rescore
    real16 = tp2.scan_topt_f16h_plain
    calls.clear()

    def spy16(*a, **kw):
        calls.append(1)
        return real16(*a, **kw)

    tp2.scan_topt_f16h_plain = spy16
    try:
        _, i = tmips.mips_topk_t(q, e.half(), 3)
        assert not calls and i[:, 0].tolist() == [0, 1]
        _, i = tmips.mips_topk_t(q, e.half(), 3, method="pallas2")
        assert calls and i[:, 0].tolist() == [0, 1]
    finally:
        tp2.scan_topt_f16h_plain = real16
    for rows in (e, e.half()):
        calls.clear()
        _, want = tmips.mips_topk_t(q, rows, 3, method="exact")
        _, got = tmips.mips_topk_t(q, rows, 3, method="approx", chunk=4096)
        assert torch.equal(got, want) and not calls


def test_dense_wrapper_refuses_what_it_cannot_take():
    q = torch.zeros((2, 16))
    e = torch.zeros((64, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tp2.scan_topt_dense(q.double(), e, 64, 128, 4)
    with pytest.raises(TypeError):
        tp2.scan_topt_dense(q, e.half(), 64, 128, 4)
    with pytest.raises(ValueError):
        tp2.scan_topt_dense(q, e, 65, 128, 4)
    with pytest.raises(ValueError):
        tp2.scan_topt_dense(q, e.t().contiguous().t(), 64, 128, 4)
    with pytest.raises(ValueError):
        tp2.scan_topt_dense(q, e, 64, 128, 129)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_index_matches_jax(dtype):
    """The port's bf16/f32 ``ShardedFlatIndex`` against the JAX package's:
    geometry, stored values (bf16 rounding included) and search results."""
    mesh = make_mesh(n_data=1, n_index=1,
                     devices=__import__("jax").devices()[:1])
    rng = np.random.default_rng(17)
    n, d, k = 2100, 32, 12
    e = _unit_rows(n, d, seed=17)
    j = JaxIndex(mesh, n, d, dtype=DTYPES[dtype][0])
    t = TorchIndex(n, d, dtype, device="cpu")
    for start in range(0, n, 500):
        j.set_embeddings(start, e[start:start + 500])
        t.set_embeddings(start, e[start:start + 500])
    assert (t.shard_rows, t.n_padded) == (j.shard_rows, j.n_padded)
    assert t.embeddings.shape == (j.n_padded, d)
    np.testing.assert_array_equal(
        t.embeddings_as_float().numpy(),
        np.asarray(j.embeddings_as_float()))
    gold = rng.integers(0, n, 6)
    q = e[gold] + 0.02 * rng.standard_normal((6, d)).astype(np.float32)
    js, ji = j.search(jnp.asarray(q), k)
    ts, ti = t.search(q, k)
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji))
    assert (ti[:, 0].numpy() == gold).all()
