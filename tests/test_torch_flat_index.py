"""Port parity: the int8r ``ShardedFlatIndex`` of ``jsa_rag_tpu_torch``
against the JAX package's on one device — stored codes, search results, the
saved format in both directions and the float decode.

Tolerances: stored codes and scales are compared exactly (both packages
quantise to the same bits). Search scores agree to 1e-5 (the refine's f32
dot products are summed in another order), ids as in ``test_torch_mips``
(ties compared as sets). ``embeddings_as_float`` agrees to 1e-6 relative:
XLA may fuse v1*s1 + v2*s2 into one multiply-add, torch rounds twice."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.index import build_index_for, load_index
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TorchIndex

from test_torch_mips import _unit_rows, assert_same_topk


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


def _stored(idx):
    """(plane 1 rows, scales, plane 2 rows, residual scales) as numpy,
    trimmed to the valid rows, in the on-disk (row-major) layout."""
    n = idx.n_passages
    if isinstance(idx, JaxIndex):
        return (np.asarray(idx.embeddings)[:, :n].T,
                np.asarray(idx.scales)[0, :n], np.asarray(idx.res)[:n],
                np.asarray(idx.res_scales)[0, :n])
    return (idx.embeddings[:n].numpy(), idx.scales[0, :n].numpy(),
            idx.res[:n].numpy(), idx.res_scales[0, :n].numpy())


def _assert_same_storage(a, b):
    for x, y in zip(_stored(a), _stored(b)):
        np.testing.assert_array_equal(x, y)


def _search(idx, q, k):
    s, i = idx.search(q if isinstance(idx, TorchIndex) else jnp.asarray(q), k)
    return np.asarray(s), np.asarray(i)


def _pair(mesh, e, block):
    """The same rows written into an index of each package, in blocks of
    ``block`` rows (the last one ragged)."""
    n, d = e.shape
    j = JaxIndex(mesh, n, d, dtype="int8r")
    t = TorchIndex(n, d, "int8r", device="cpu")
    for start in range(0, n, block):
        j.set_embeddings(start, e[start:start + block])
        t.set_embeddings(start, e[start:start + block])
    return j, t


@pytest.mark.parametrize("n", [5, 700, 2100])
def test_geometry_matches_jax(mesh1, n):
    j = JaxIndex(mesh1, n, 8, dtype="int8r")
    t = TorchIndex(n, 8, "int8r", device="cpu")
    assert (t.shard_rows, t.n_padded) == (j.shard_rows, j.n_padded)
    assert t.embeddings.shape == (j.n_padded, 8)  # row-major plane 1
    assert t.res.shape == j.res.shape
    assert t.scales.shape == j.scales.shape == (1, j.n_padded)
    assert t.embeddings.element_size() + t.res.element_size() == 2


@pytest.mark.parametrize("n,k", [(700, 12), (40, 64)])
def test_int8r_index_matches_jax(mesh1, n, k):
    """Ragged block writes store the same codes; searches return the same
    results, also where k exceeds the passages (and clamps to them)."""
    rng = np.random.default_rng(53)
    d = 32
    e = _unit_rows(n, d, seed=53)
    j, t = _pair(mesh1, e, 256 if n > 256 else 16)
    _assert_same_storage(j, t)
    gold = rng.integers(0, n, 6)
    q = e[gold] + 0.02 * rng.standard_normal((6, d)).astype(np.float32)
    (js, ji), (ts, ti) = _search(j, q, k), _search(t, q, k)
    assert ti.shape == (6, min(k, n)) and ti.min() >= 0 and ti.max() < n
    assert_same_topk(ts, ti, js, ji)
    assert (ti[:, 0] == gold).all()
    if k >= n:
        assert all(len(set(row)) == n for row in ti)


def test_overwrite_takes_effect(mesh1):
    """A rebuild over the same rows replaces every plane (no stale data)."""
    n, d = 300, 16
    e = _unit_rows(n, d, seed=7)
    j, t = _pair(mesh1, np.roll(e, 3, axis=0), 128)
    for idx in (j, t):
        idx.set_embeddings(0, e)
    _assert_same_storage(j, t)
    q = e[[4, 50]]
    assert _search(t, q, 1)[1][:, 0].tolist() == [4, 50]


def test_save_load_both_ways(mesh1, tmp_path):
    """JAX save -> port load and port save -> JAX load: identical stored
    codes and identical search results."""
    n, d, k = 530, 16, 9
    e = _unit_rows(n, d, seed=59)
    j, t = _pair(mesh1, e, 200)
    q = _unit_rows(4, d, seed=61)
    j.save(str(tmp_path / "from_jax"), n_files=4)
    t.save(str(tmp_path / "from_torch"), n_files=3)
    with open(tmp_path / "from_jax" / "meta.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "from_torch" / "meta.json") as f:
        tmeta = json.load(f)
    assert {k: v for k, v in tmeta.items() if k != "n_files"} == \
        {k: v for k, v in jmeta.items() if k != "n_files"}

    t2 = load_index(str(tmp_path / "from_jax"), device="cpu")
    j2 = JaxIndex.load(str(tmp_path / "from_torch"), mesh1)
    _assert_same_storage(j, t2)
    _assert_same_storage(t, j2)
    ref_s, ref_i = _search(j, q, k)
    for idx in (t, t2):
        s, i = _search(idx, q, k)
        assert_same_topk(s, i, ref_s, ref_i)
    s, i = _search(j2, q, k)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_array_equal(s, ref_s)
    # port -> port is exact
    t3 = load_index(str(tmp_path / "from_torch"), device="cpu", refine_r=4)
    s3, i3 = _search(t3, q, k)
    ts, ti = _search(t, q, k)
    np.testing.assert_array_equal(i3, ti)
    np.testing.assert_array_equal(s3, ts)


def test_embeddings_as_float_matches(mesh1):
    n, d = 300, 24
    e = _unit_rows(n, d, seed=3) * 2.5
    j, t = _pair(mesh1, e, 128)
    got = t.embeddings_as_float().numpy()
    np.testing.assert_allclose(got, np.asarray(j.embeddings_as_float()),
                               rtol=1e-6, atol=1e-9)
    # the two-plane decode beats fp16 rounding of the same rows
    assert np.abs(got - e).max() < np.abs(
        e.astype(np.float16).astype(np.float32) - e).max()


def test_unported_modes_raise(mesh1, tmp_path):
    """An unknown strategy or dtype is an error. float16, which raised here
    until its kernels were ported, now loads from a JAX save; so does IVF,
    built or loaded, which raised until it was ported: ``load_index``
    dispatches an IVF directory to ``ShardedIVFIndex``, and the flat
    loader refuses one, naming ``load_index``."""
    with pytest.raises(ValueError, match="rows1"):
        TorchIndex(10, 8, device="cpu", int8r_refine="row")
    with pytest.raises(ValueError, match="index dtype"):
        TorchIndex(10, 8, dtype="int4", device="cpu")
    j = JaxIndex(mesh1, 40, 8, dtype=jnp.float16)
    j.set_embeddings(0, _unit_rows(40, 8))
    j.save(str(tmp_path / "f16"), n_files=2)
    assert load_index(str(tmp_path / "f16"), device="cpu").storage == \
        "float16"
    with open(tmp_path / "f16" / "meta.json") as f:
        meta = json.load(f)
    meta["kind"] = "ivf"
    with open(tmp_path / "f16" / "meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="load_index"):
        TorchIndex.load(str(tmp_path / "f16"), device="cpu")
    from jsa_rag_tpu.index.ivf import ShardedIVFIndex as JaxIVF
    from jsa_rag_tpu_torch.index.ivf import ShardedIVFIndex as TorchIVF

    jivf = JaxIVF(mesh1, 40, 8, dtype=jnp.float32, n_lists=4, n_probe=4)
    jivf.train(jnp.asarray(_unit_rows(40, 8)), iters=3)
    jivf.save(str(tmp_path / "ivf"), n_files=2)
    assert isinstance(load_index(str(tmp_path / "ivf"), device="cpu"),
                      TorchIVF)

    class Opt:
        index_mode, faiss_index_type, index_dtype = "flat", "ivfpq", "int8r"
        refine_gather, int8r_refine, refine_r = "cols", "rows", 6

    idx = build_index_for(Opt, 50, 8, device="cpu")
    assert idx.refine_r == 6 and idx.device == torch.device("cpu")
    Opt.index_mode = "ivf"
    Opt.ivf_n_lists, Opt.ivf_n_probe, Opt.ivf_refine = 0, 0, False
    Opt.faiss_code_size = 8
    ivf = build_index_for(Opt, 50, 8, device="cpu")
    assert isinstance(ivf, TorchIVF) and ivf.storage == "sq8"
    assert ivf.refine and ivf.refine_r == 6
