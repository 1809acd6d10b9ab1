"""Port parity: the single-plane int8 scan (kernel B2's plain version), every
branch of ``mips_topk_int8_t`` and the int8 / hybrid ``ShardedFlatIndex``
against the JAX package on the same numpy inputs. The JAX Pallas wrapper
runs in interpret mode (its default off the TPU); the port runs the plain
version, as it does for every CPU tensor.

Tolerances. The per-tile scan: ids equal in every slot and scores equal to
1e-6 relative — both packages compute (acc * qs) * es in f32 from the same
int8 codes (the query codes come from quantisers that agree bit for bit,
``test_torch_mips``). Searches: scores within 1e-6 (``TOL``) relative and
absolute — the refines' f32 dot products are summed in another order by XLA
and by torch (<= d * 2^-24 relative, ~2e-6 at d = 32 on unit rows, far less
in practice) — and ids equal except among scores tied within that
tolerance. Hybrid storage's fp16 rows are equal bit for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.ops import mips_pallas2 as jp2
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.index import load_index
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TorchIndex
from jsa_rag_tpu_torch.ops import mips_topt as tp2

from test_torch_mips import _t, _unit_rows, assert_same_topk

TOL = 1e-6
TILE_N = 256


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


def _int8_rows(e):
    v, s = (np.asarray(a) for a in jp2.quantize_int8(jnp.asarray(e)))
    return v, s.reshape(1, -1)


@pytest.mark.parametrize("b,n,nv,d,k_sel,tile", [
    (2, 1500, 1400, 64, 40, 256),   # the train step's 2 queries
    (5, 4099, 3000, 32, 4096, 256),  # more candidates than valid rows
    (9, 300, 300, 16, 20, 128),
])
def test_scan_plain_matches_jax_kernel(b, n, nv, d, k_sel, tile):
    """``scan_topt_int8_plain`` against ``_topt_int8_kernel_t`` run by the
    JAX wrapper's own ``pallas_call`` (interpret mode), per tile and slot."""
    import functools

    from jax.experimental import pallas as pl

    rng = np.random.default_rng(n + b)
    v, s = _int8_rows(rng.standard_normal((n, d)).astype(np.float32))
    qv, qs = (np.asarray(a) for a in jp2.quantize_int8(
        jnp.asarray(rng.standard_normal((b, d)).astype(np.float32))))
    t = tp2._pool_t(k_sel, nv, tile, 4)
    n_tiles = -(-n // tile)
    vt = np.zeros((d, n_tiles * tile), np.int8)
    vt[:, :n] = v.T
    st = np.zeros((1, n_tiles * tile), np.float32)
    st[:, :n] = s
    kernel = functools.partial(jp2._topt_int8_kernel_t, t_per_tile=t,
                               tile_n=tile)
    js, ji = pl.pallas_call(
        kernel, grid=(1, n_tiles),
        in_specs=[pl.BlockSpec((b, d), lambda qt, nt: (qt, 0)),
                  pl.BlockSpec((b, 1), lambda qt, nt: (qt, 0)),
                  pl.BlockSpec((d, tile), lambda qt, nt: (0, nt)),
                  pl.BlockSpec((1, tile), lambda qt, nt: (0, nt)),
                  pl.BlockSpec((1,), lambda qt, nt: (0,))],
        out_specs=[pl.BlockSpec((1, b, t), lambda qt, nt: (nt, qt, 0)),
                   pl.BlockSpec((1, b, t), lambda qt, nt: (nt, qt, 0))],
        out_shape=[jax.ShapeDtypeStruct((n_tiles, b, t), jnp.float32),
                   jax.ShapeDtypeStruct((n_tiles, b, t), jnp.int32)],
        interpret=True)(jnp.asarray(qv), jnp.asarray(qs), jnp.asarray(vt),
                        jnp.asarray(st), jnp.asarray([nv], jnp.int32))
    ts, ti = tp2.scan_topt_int8_plain(_t(qv), _t(qs), _t(v), _t(s), nv,
                                      tile, t)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=TOL, atol=0)
    assert (ti.numpy()[ti.numpy() >= 0] < nv).all()


def _both(q, v, s, k, **kw):
    """The same search through ``mips_topk_pallas2_int8_t`` and
    ``mips_topk_int8_t``; ``kw`` holds numpy storage operands."""
    jkw, tkw = {}, {}
    for name in ("valid_n", "pool_n", "refine", "int8r_refine"):
        if name in kw:
            jkw[name] = tkw[name] = kw[name]
    if "f16_rows" in kw:
        jkw["emb_rows"] = jnp.asarray(kw["f16_rows"].view(np.int16))
        tkw["f16_rows"] = _t(kw["f16_rows"])
    for name in ("res_rows", "res_scale"):
        if name in kw:
            jkw[name], tkw[name] = jnp.asarray(kw[name]), _t(kw[name])
    js, ji = jp2.mips_topk_pallas2_int8_t(
        jnp.asarray(q), jnp.asarray(v.T), jnp.asarray(s), k, tile_n=TILE_N,
        **jkw)
    ts, ti = tp2.mips_topk_int8_t(_t(q), _t(v), _t(s), k, tile_n=TILE_N,
                                  **tkw)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    return (np.asarray(js), np.asarray(ji)), (ts.numpy(), ti.numpy())


@pytest.mark.parametrize("branch", ["int8", "hybrid", "rows1", "cols"])
@pytest.mark.parametrize("n,nv,d,b,k", [(1500, 1500, 32, 6, 10),
                                        (700, 650, 64, 2, 40),
                                        (104, 104, 16, 3, 100)])
def test_wrapper_branch_matches_jax(branch, n, nv, d, b, k):
    """Each non-two-plane branch of the wrapper returns the JAX wrapper's
    top-k: int8 (refine 0), hybrid (fp16 refine), int8r rows1 and cols —
    with a valid count below the rows, and refine*k past the valid rows
    (the -1 sentinel must never surface as a passage)."""
    rng = np.random.default_rng(n * 7 + d)
    e = _unit_rows(n, d, seed=n + d)
    gold = rng.integers(0, nv, b)
    q = e[gold] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    kw = dict(valid_n=nv, pool_n=nv)
    if branch == "int8":
        v, s = _int8_rows(e)
    elif branch == "hybrid":
        f16 = e.astype(np.float16)
        v, s = (np.asarray(a) for a in jp2.hybrid_int8_from_bits(
            jnp.asarray(f16.view(np.int16))))
        s = s.reshape(1, -1)
        kw.update(refine=4, f16_rows=f16)
    else:
        v1, s1, v2, s2 = (np.asarray(a) for a in
                          jp2.quantize_int8_residual(jnp.asarray(e)))
        v, s = v1, s1.reshape(1, -1)
        kw.update(refine=4, res_rows=v2, res_scale=s2.reshape(1, -1),
                  int8r_refine=branch)
    (js, ji), (ts, ti) = _both(q, v, s, k, **kw)
    assert ti.shape == (b, min(k, n)) and ti.min() >= 0 and ti.max() < nv
    assert_same_topk(ts, ti, js, ji, tol=TOL)
    if branch != "int8" and k <= nv:
        assert (ti[:, 0] == gold).all()
    if k >= nv:
        assert all(len(set(row)) == min(k, nv) for row in ti)


def test_hybrid_coarse_copy_matches_jax():
    """``hybrid_int8_from_f16`` decodes the stored fp16 values exactly
    (subnormals kept) and quantises them as the JAX package's
    ``hybrid_int8_from_bits`` does: codes equal, scales within 1 ulp."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 24)).astype(np.float16)
    x[3] = np.float16(3e-6)  # subnormal fp16 row
    jv, js = (np.asarray(a) for a in jp2.hybrid_int8_from_bits(
        jnp.asarray(x.view(np.int16))))
    tv, ts = tp2.hybrid_int8_from_f16(_t(x))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=1)
    assert ts.shape == (40,) and (tv.numpy()[3] != 0).any()


def _pair(mesh, e, dtype, block):
    n, d = e.shape
    j = JaxIndex(mesh, n, d, dtype=jnp.int8 if dtype == "int8" else dtype)
    t = TorchIndex(n, d, dtype, device="cpu")
    for start in range(0, n, block):
        j.set_embeddings(start, e[start:start + block])
        t.set_embeddings(start, e[start:start + block])
    return j, t


def _stored(idx):
    """Stored rows (and int8 scales) as numpy, row-major, valid rows only."""
    n = idx.n_passages
    if isinstance(idx, JaxIndex):
        e = np.asarray(idx.embeddings)
        if idx.store_hybrid:
            return (e[:n].view(np.float16),)
        return e[:, :n].T, np.asarray(idx.scales)[0, :n]
    e = idx.embeddings[:n].numpy()
    if idx.store_hybrid:
        return (e,)
    return e, idx.scales[0, :n].numpy()


def _search(idx, q, k):
    s, i = idx.search(q if isinstance(idx, TorchIndex) else jnp.asarray(q), k)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("dtype", ["int8", "hybrid"])
@pytest.mark.parametrize("n,k", [(700, 12), (2100, 30), (40, 64)])
def test_index_matches_jax(mesh1, dtype, n, k):
    """Ragged block writes store the same rows; searches return the same
    results (padded tail masked, k past the passages clamped)."""
    rng = np.random.default_rng(n)
    d = 32
    e = _unit_rows(n, d, seed=n)
    j, t = _pair(mesh1, e, dtype, 256 if n > 256 else 16)
    assert (t.shard_rows, t.n_padded) == (j.shard_rows, j.n_padded)
    for x, y in zip(_stored(j), _stored(t)):
        np.testing.assert_array_equal(x, y)
    gold = rng.integers(0, n, 5)
    q = e[gold] + 0.02 * rng.standard_normal((5, d)).astype(np.float32)
    (js, ji), (ts, ti) = _search(j, q, k), _search(t, q, k)
    assert ti.shape == (5, min(k, n)) and ti.min() >= 0 and ti.max() < n
    assert_same_topk(ts, ti, js, ji, tol=TOL)
    if dtype == "hybrid":
        assert (ti[:, 0] == gold).all()


def test_hybrid_rederives_after_write(mesh1):
    """A write after a search makes the next search derive the coarse copy
    anew (the derivation count steps), and it finds the new rows."""
    n, d = 300, 16
    e = _unit_rows(n, d, seed=8)
    t = TorchIndex(n, d, "hybrid", device="cpu")
    t.set_embeddings(0, np.roll(e, 5, axis=0))
    _search(t, e[:2], 1)
    assert t.hybrid_derivations == 1
    _search(t, e[:2], 1)
    assert t.hybrid_derivations == 1
    t.set_embeddings(0, e)
    assert _search(t, e[[4, 50]], 1)[1][:, 0].tolist() == [4, 50]
    assert t.hybrid_derivations == 2
    codes, scales = t.hybrid_copies()
    want_v, want_s = tp2.hybrid_int8_from_f16(t.embeddings)
    assert torch.equal(codes, want_v) and torch.equal(scales[0], want_s)


@pytest.mark.parametrize("dtype", ["int8", "hybrid"])
def test_save_load_both_ways(mesh1, tmp_path, dtype):
    """JAX save -> port load and port save -> JAX load: the same meta, the
    same stored rows and the same search results (port -> port exact)."""
    n, d, k = 530, 16, 9
    e = _unit_rows(n, d, seed=59)
    j, t = _pair(mesh1, e, dtype, 200)
    q = _unit_rows(4, d, seed=61)
    j.save(str(tmp_path / "from_jax"), n_files=4)
    t.save(str(tmp_path / "from_torch"), n_files=3)
    metas = []
    for name in ("from_jax", "from_torch"):
        with open(tmp_path / name / "meta.json") as f:
            metas.append({k_: v for k_, v in json.load(f).items()
                          if k_ != "n_files"})
    assert metas[0] == metas[1]
    t2 = load_index(str(tmp_path / "from_jax"), device="cpu", refine_r=4)
    j2 = JaxIndex.load(str(tmp_path / "from_torch"), mesh1)
    assert t2.storage == dtype
    for a, b in ((j, t2), (t, j2)):
        for x, y in zip(_stored(a), _stored(b)):
            np.testing.assert_array_equal(x, y)
    ref_s, ref_i = _search(j, q, k)
    for idx in (t, t2, j2):
        s, i = _search(idx, q, k)
        assert_same_topk(s, i, ref_s, ref_i, tol=TOL)
    s3, i3 = _search(load_index(str(tmp_path / "from_torch"), device="cpu"),
                     q, k)
    ts, ti = _search(t, q, k)
    np.testing.assert_array_equal(i3, ti)
    np.testing.assert_array_equal(s3, ts)


def test_int8_embeddings_as_float(mesh1):
    e = _unit_rows(300, 24, seed=3) * 2.5
    j, t = _pair(mesh1, e, "int8", 128)
    np.testing.assert_allclose(t.embeddings_as_float().numpy(),
                               np.asarray(j.embeddings_as_float()),
                               rtol=1e-6, atol=0)
