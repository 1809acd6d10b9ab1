"""Port parity: the IVF index, k-means, the PQ helpers and the approximate
MIPS of ``jsa_rag_tpu_torch`` against the JAX package on the CPU, on the
same numpy inputs; the JAX IVF runs on a one-device mesh.

Tolerances. k-means from the same initial centroids (and the same split
noise, drawn with ``jax.random`` here: torch's generator cannot replay
threefry): assignments equal, centroids within 1e-5 relative and absolute
(f32 sums of a cluster's rows in another order). PQ codes equal wherever
the best codeword wins by more than 1e-4 (a closer gap is an argmax tie
that the two libraries' f32 sums may break apart); decoded rows equal for
equal codes. ``quantize_int8`` bit-equal. A search over an IVF directory
that either package saved: the same id set per query, scores within 1e-5
(f32 rows, sq8, pq) or 1e-3 (bf16 rows). The port's own build is held to
the JAX package's bars (``tests/test_ivf.py``). The training loops: losses
to 1e-4 relative, as ``tests/test_torch_train.py``. approx: equal ids (the
JAX scan on the CPU is exact, as the port's is)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index.flat import ShardedFlatIndex as JFlat
from jsa_rag_tpu.index.ivf import ShardedIVFIndex as JIVF
from jsa_rag_tpu.index import ivf as jivf
from jsa_rag_tpu.ops import kmeans as jkmeans
from jsa_rag_tpu.ops import mips as jmips
from jsa_rag_tpu.ops.mips_pallas2 import quantize_int8 as jquantize
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.config import Options
from jsa_rag_tpu_torch.index import build_index_for, load_index
from jsa_rag_tpu_torch.index import ivf as tivf
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TFlat
from jsa_rag_tpu_torch.index.ivf import ShardedIVFIndex as TIVF
from jsa_rag_tpu_torch.ops import kmeans as tkmeans
from jsa_rag_tpu_torch.ops import mips as tmips
from jsa_rag_tpu_torch.ops.mips_topt import quantize_int8 as tquantize


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


def make_clustered(n_clusters=8, per=64, d=16, seed=0):
    """tests/test_ivf.py's fixture: tight gaussian clusters, shuffled."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 4
    e = np.concatenate([
        centers[i] + 0.3 * rng.standard_normal((per, d))
        for i in range(n_clusters)]).astype(np.float32)
    return e[rng.permutation(len(e))]


def _near(e, n, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    return (e[rng.integers(0, len(e), n)]
            + noise * rng.standard_normal((n, e.shape[1]))).astype(
                np.float32)


def _recall(vi, fi, k=10):
    vi, fi = np.asarray(vi), np.asarray(fi)
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k
                          for a, b in zip(vi, fi)]))


# ------------------------------------------------------------------ k-means
def _jax_init(e, key, n_clusters, iters):
    """The JAX kmeans' initial centroids and per-iteration split noise,
    replayed from its key (``kmeans.py:63-66, 80-81, 105-107``)."""
    init_key, loop_key = jax.random.split(key)
    idx = jax.random.choice(init_key, e.shape[0], (n_clusters,),
                            replace=False)
    noise, k = [], loop_key
    for _ in range(iters):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(
            sub, (n_clusters, e.shape[1]))))
    return e[np.asarray(idx)], np.stack(noise)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("spherical", [False, True])
def test_lloyd_from_jax_init_matches_jax_kmeans(metric, spherical):
    e = make_clustered(n_clusters=8, per=64, d=16, seed=3)
    key = jax.random.PRNGKey(5)
    iters, chunk = 6, 96  # 512 rows: five full chunks and a ragged one
    jc, ja = jkmeans.kmeans(jnp.asarray(e), key, 8, iters=iters, chunk=chunk,
                            metric=metric, spherical=spherical)
    init, noise = _jax_init(e, key, 8, iters)
    tc, ta = tkmeans.lloyd(torch.from_numpy(e), torch.from_numpy(init),
                           iters=iters, chunk=chunk, metric=metric,
                           spherical=spherical,
                           noise=torch.from_numpy(noise))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_lloyd_split_matches_jax_on_empty_clusters():
    """Three times more clusters than natural groups: the first two
    iterations leave 8 and 7 clusters empty, and the split (the i-th empty
    slot copies the i-th most populated centroid plus the noise) takes the
    JAX package's donors. Two iterations only: a split pair differs by
    ~1e-3 relative, so the rows of its cluster sit at argmax near-ties that
    the two libraries' f32 sums break apart from the third on."""
    e = make_clustered(n_clusters=4, per=32, d=8, seed=4)
    key = jax.random.PRNGKey(2)
    jc, ja = jkmeans.kmeans(jnp.asarray(e), key, 12, iters=2, chunk=64)
    init, noise = _jax_init(e, key, 12, 2)
    tc, ta = tkmeans.lloyd(torch.from_numpy(e), torch.from_numpy(init),
                           iters=2, chunk=64, noise=torch.from_numpy(noise))
    assert (np.bincount(np.asarray(ja), minlength=12) == 0).sum() == 7
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_kmeans_clusters_separable():
    e = make_clustered()
    cents, assign = tkmeans.kmeans(
        torch.from_numpy(e), 8, iters=15, chunk=128,
        generator=torch.Generator().manual_seed(0))
    assign = assign.numpy()
    # every point's assigned centroid is its nearest by inner product
    s = e @ cents.numpy().T
    np.testing.assert_array_equal(assign, s.argmax(1))
    counts = np.bincount(assign, minlength=8)
    assert (counts > 0).sum() >= 6


def test_kmeans_splits_empty_clusters():
    """tests/test_ivf.py:38's fixture and bars: a zipf-skewed corpus with
    2x more lists than natural clusters keeps dead lists rare and the
    largest list (the capacity pad) small."""
    rng = np.random.default_rng(0)
    n, c_nat, d = 12000, 32, 48
    centers = rng.standard_normal((c_nat, d)).astype(np.float32)
    sizes = np.arange(1, c_nat + 1, dtype=np.float64) ** -1.2
    sizes = (sizes / sizes.sum() * n).astype(int)
    sizes[0] += n - sizes.sum()
    pts = np.concatenate([
        centers[i] + 0.15 * rng.standard_normal((s, d)).astype(np.float32)
        for i, s in enumerate(sizes)])
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    _, assign = tkmeans.kmeans(torch.from_numpy(pts), 64, iters=10,
                               chunk=2048,
                               generator=torch.Generator().manual_seed(1))
    counts = np.bincount(assign.numpy(), minlength=64)
    assert (counts == 0).sum() <= 2, counts
    assert counts.max() <= 700, counts.max()


def test_kmeans_refuses_too_few_points_and_bad_metric():
    with pytest.raises(ValueError, match="clusters but only"):
        tkmeans.kmeans(torch.zeros((3, 4)), 4)
    with pytest.raises(ValueError, match="metric"):
        tkmeans.kmeans(torch.randn((8, 4)), 2, metric="cos")


def test_auto_n_lists_matches_jax():
    for n in (0, 1, 100, 255, 256, 1_000_000, 1_300_000, 21_000_000):
        assert tivf.auto_n_lists(n) == jivf.auto_n_lists(n)
    assert tivf.auto_n_lists(1_300_000) == 1140


# ------------------------------------------------- PQ and quantisation
def test_pq_encode_decode_match_jax():
    rng = np.random.default_rng(0)
    m, ds, rows = 8, 4, 600
    books = rng.standard_normal((m, 256, ds)).astype(np.float32)
    res = rng.standard_normal((rows, m * ds)).astype(np.float32)
    jcodes = np.asarray(jivf._pq_encode(jnp.asarray(res), jnp.asarray(books)))
    tcodes = tivf._pq_encode(torch.from_numpy(res),
                             torch.from_numpy(books)).numpy()
    assert tcodes.dtype == np.uint8 and tcodes.shape == (rows, m)
    # argmax ties: the best codeword wins by at most 1e-4
    s = np.einsum("rmd,mkd->rmk", res.reshape(rows, m, ds), books)
    s = s - 0.5 * np.square(books).sum(-1)[None]
    top2 = np.sort(s, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    np.testing.assert_array_equal(tcodes[clear], jcodes[clear])
    assert clear.mean() > 0.99
    jdec = np.asarray(jivf._pq_decode(jnp.asarray(jcodes),
                                      jnp.asarray(books)))
    tdec = tivf._pq_decode(torch.from_numpy(jcodes.copy()),
                           torch.from_numpy(books)).numpy()
    np.testing.assert_array_equal(tdec, jdec)


def test_quantize_int8_bit_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((300, 48)) * 3).astype(np.float32)
    x[0] = 0.0  # the 1e-12 floor
    jv, js = jquantize(jnp.asarray(x))
    tv, ts = tquantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------- IVF directories across packages
D = 64
CASES = {
    "dense-bf16": dict(dtype="bfloat16", storage="dense", code_size=32,
                       refine=False, tol=1e-3),
    "dense-f32": dict(dtype="float32", storage="dense", code_size=32,
                      refine=False, tol=1e-5),
    "sq8": dict(dtype="bfloat16", storage="sq8", code_size=32, refine=False,
                tol=1e-5),
    "pq32": dict(dtype="bfloat16", storage="pq", code_size=32,
                 refine=False, tol=1e-5),
    "pq-refine": dict(dtype="bfloat16", storage="pq", code_size=16,
                      refine=True, tol=1e-5),
    # 32-wide subvectors, as pq-32 at d=1024
    "pq2": dict(dtype="float32", storage="pq", code_size=2, refine=False,
                tol=1e-5),
}
JDTYPE = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}


@pytest.fixture(scope="module")
def corpus64():
    return make_clustered(n_clusters=16, per=32, d=D, seed=7)


def _search(idx, q, k, n_probe):
    if isinstance(idx, TIVF):
        s, i = idx.search(torch.from_numpy(q), k, n_probe=n_probe)
        return s.numpy(), i.numpy()
    s, i = idx.search(jnp.asarray(q), k, n_probe=n_probe)
    return np.asarray(s), np.asarray(i)


def _assert_same_search(a, b, q, tol, n_lists, k=10):
    for n_probe in (1, 4, n_lists):
        sa, ia = _search(a, q, k, n_probe)
        sb, ib = _search(b, q, k, n_probe)
        for row in range(len(q)):
            assert set(ia[row]) == set(ib[row]), (n_probe, row, ia[row],
                                                  ib[row])
        np.testing.assert_allclose(sa, sb, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_loads_jax_ivf_directories(tmp_path, mesh1, corpus64, case):
    c = CASES[case]
    j = JIVF(mesh1, len(corpus64), D, dtype=JDTYPE[c["dtype"]], n_lists=16,
             n_probe=4, storage=c["storage"], code_size=c["code_size"],
             refine=c["refine"])
    j.train(jnp.asarray(corpus64), key=jax.random.PRNGKey(1), iters=5)
    j.save(str(tmp_path / "j"), n_files=3)
    t = load_index(str(tmp_path / "j"), device="cpu")
    assert isinstance(t, TIVF)
    assert (t.storage, t.refine, t.cap, t.n_lists) == (
        j.storage, j.refine, j.cap, j.n_lists)
    if c["storage"] == "dense":
        assert t.list_rows.dtype == {"bfloat16": torch.bfloat16,
                                    "float32": torch.float32}[c["dtype"]]
    q = _near(corpus64, 6, seed=11)
    _assert_same_search(t, j, q, c["tol"], 16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_loads_port_ivf_directories(tmp_path, mesh1, corpus64, case):
    c = CASES[case]
    t = TIVF(len(corpus64), D, c["dtype"], device="cpu", n_lists=16,
             n_probe=4, storage=c["storage"], code_size=c["code_size"],
             refine=c["refine"])
    t.train(torch.from_numpy(corpus64), iters=5)
    t.save(str(tmp_path / "t"), n_files=3)
    j = JIVF.load(str(tmp_path / "t"), mesh1)
    assert (j.storage, j.refine, j.cap) == (t.storage, t.refine, t.cap)
    q = _near(corpus64, 6, seed=12)
    _assert_same_search(j, t, q, c["tol"], 16)


def _tied_corpus(seed=5):
    """Rows in {-1, 0, 1} with a quarter of them repeated, and queries that
    are rows: integer scores, equal across lists and between copies, exact
    in bf16, fp16 and f32."""
    rng = np.random.default_rng(seed)
    e = rng.choice(np.float32([-1, 0, 1]), size=(384, D))
    e = np.concatenate([e, e[rng.integers(0, 384, 128)]])
    return e[rng.permutation(len(e))], e[rng.integers(0, len(e), 6)]


@pytest.mark.parametrize("data", ["clustered", "tied"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_scan_matches_jax_and_one_group(tmp_path, mesh1, corpus64,
                                                monkeypatch, case, data):
    """The union scored in many groups (GROUP_BYTES cut to one row's f32,
    so each list is a group read in place, and to 100 rows, so a partial
    probe gathers a few lists a group) returns the JAX lax.scan's ids and
    scores, and the one-group run's ids with its scores to 1e-6: the
    carry-first merge keeps equal scores in (list, row) order."""
    c = CASES[case]
    e, q = ((corpus64, _near(corpus64, 6, seed=13)) if data == "clustered"
            else _tied_corpus())
    j = JIVF(mesh1, len(e), D, dtype=JDTYPE[c["dtype"]], n_lists=16,
             n_probe=4, storage=c["storage"], code_size=c["code_size"],
             refine=c["refine"])
    j.train(jnp.asarray(e), key=jax.random.PRNGKey(2), iters=5)
    j.save(str(tmp_path / "j"), n_files=3)
    t = load_index(str(tmp_path / "j"), device="cpu")
    one = {p: _search(t, q, 10, p) for p in (1, 4, 16)}
    kinds = set()
    for rows in (1, 100):
        monkeypatch.setattr(tivf, "GROUP_BYTES", rows * D * 4)
        for p in (1, 4, 16):
            _, probed = tivf.top_k_lax(
                torch.from_numpy(q) @ t.centroids.T, p)
            groups = t._groups(torch.unique(probed).tolist())
            kinds |= {type(g).__name__ for g in groups}
            if p > 1:
                assert len(groups) > 1, (rows, p)
            s, i = _search(t, q, 10, p)
            np.testing.assert_array_equal(i, one[p][1])
            np.testing.assert_allclose(s, one[p][0], rtol=1e-6, atol=1e-6)
            sj, ij = _search(j, q, 10, p)
            for row in range(len(q)):
                assert set(i[row]) == set(ij[row]), (rows, p, row, i[row],
                                                     ij[row])
            np.testing.assert_allclose(s, sj, rtol=c["tol"], atol=c["tol"])
    assert kinds == {"slice", "Tensor"}


# ----------------------------------------------------- the port's own build
@pytest.fixture(scope="module")
def flat32():
    e = make_clustered(n_clusters=16, per=64, d=32, seed=1)  # 1024 rows
    flat = TFlat(len(e), 32, "float32", device="cpu", method="exact")
    flat.set_embeddings(0, e)
    return e, flat


def test_ivf_full_probe_matches_flat(flat32):
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10)
    q = np.random.default_rng(2).standard_normal((5, 32)).astype(np.float32)
    fs, _ = flat.search(q, 10)
    vs, _ = ivf.search(q, 10, n_probe=16)
    np.testing.assert_allclose(vs.numpy(), fs.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("storage,code_size,bar", [("dense", 32, 0.99),
                                                   ("pq", 8, 0.7)])
def test_ivf_recall_improves_with_nprobe(flat32, storage, code_size, bar):
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=1, iters=10,
                         storage=storage, code_size=code_size)
    q = _near(e, 16, seed=3, noise=0.1)
    _, fi = flat.search(q, 10)
    r = [_recall(ivf.search(q, 10, n_probe=p)[1], fi) for p in (1, 4, 16)]
    assert r[2] >= r[1] >= r[0] or storage == "pq" and r[2] >= r[0]
    assert r[2] >= bar
    if storage == "dense":
        assert r[0] >= 0.5  # clustered queries mostly land in their list


def test_ivf_no_pad_ids(flat32):
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=4, iters=5)
    q = np.random.default_rng(4).standard_normal((3, 32)).astype(np.float32)
    _, vi = ivf.search(q, 10)
    assert vi.min() >= 0 and vi.max() < len(e)


def test_ivf_unfilled_slots_stay_minus_one(flat32):
    """Fewer valid rows in the probed lists than k: the slots come back -1
    with the f32 minimum, and the JAX package's RAG model would refuse
    them (``passage_texts``)."""
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=1, iters=5)
    s, i = ivf.search(e[:1], ivf.cap + 8, n_probe=1)
    assert (i[0] == -1).sum() >= 8
    assert torch.all(s[0][i[0] == -1] == tivf.NEG_INF)


def test_ivf_sq8_full_probe_near_flat(flat32):
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10,
                         storage="sq8")
    assert ivf.list_rows.dtype == torch.int8
    q = _near(e, 16, seed=6)
    _, fi = flat.search(q, 10)
    _, vi = ivf.search(q, 10, n_probe=16)
    assert _recall(vi, fi) >= 0.95
    assert np.mean(vi[:, 0].numpy() == fi[:, 0].numpy()) >= 0.9


def test_ivf_pq_recall_and_memory(flat32):
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10,
                         storage="pq", code_size=8)
    assert ivf.list_rows.dtype == torch.uint8
    assert ivf.list_rows.shape == (len(e), 8)  # 8 bytes a row, not 32 x 4
    q = _near(e, 32, seed=7)
    _, fi = flat.search(q, 10)
    _, vi = ivf.search(q, 10, n_probe=16)
    assert _recall(vi, fi) >= 0.7
    fi, vi = fi.numpy(), vi.numpy()
    assert np.mean([fi[i, 0] in set(vi[i]) for i in range(len(q))]) >= 0.9


@pytest.mark.parametrize("storage,code_size,dtype", [
    ("dense", 32, "float32"), ("dense", 32, "bfloat16"), ("sq8", 32, "float32"),
    ("pq", 8, "float32")])
def test_ivf_save_load(tmp_path, flat32, storage, code_size, dtype):
    e, flat = flat32
    ivf = TIVF(len(e), 32, dtype, device="cpu", n_lists=16, n_probe=4,
               storage=storage, code_size=code_size)
    ivf.train(e, iters=5)
    q = np.random.default_rng(9).standard_normal((3, 32)).astype(np.float32)
    v1, i1 = ivf.search(q, 8)
    ivf.save(str(tmp_path / "ivf"))
    ivf2 = load_index(str(tmp_path / "ivf"), device="cpu")
    assert ivf2.storage == storage and ivf2.list_rows.dtype == \
        ivf.list_rows.dtype
    assert ivf2.offsets == ivf.offsets and ivf2.cap == ivf.cap
    v2, i2 = ivf2.search(q, 8)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())


def _f16_oracle_ids(e, q, k):
    s = q @ e.astype(np.float16).astype(np.float32).T
    return np.argsort(-s, axis=1)[:, :k]


@pytest.mark.parametrize("storage,code_size", [("sq8", 32), ("pq", 8)])
def test_ivf_refine_exact_at_full_pool(flat32, storage, code_size):
    """With full probe and a pool covering every probed row, the quantised
    index returns exactly the fp16 top-k."""
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10,
                         storage=storage, code_size=code_size, refine=True)
    assert ivf.list_rows_f16.dtype == torch.float16
    ivf.refine_r = 10_000
    q = _near(e, 16, seed=11)
    _, vi = ivf.search(q, 10, n_probe=16)
    oi = _f16_oracle_ids(e, q, 10)
    for row in range(len(q)):
        assert set(vi[row].tolist()) == set(oi[row].tolist())


def test_ivf_pq_refine_beats_plain(flat32):
    e, flat = flat32
    plain = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10,
                           storage="pq", code_size=8)
    ref = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10,
                         storage="pq", code_size=8, refine=True)
    q = _near(e, 32, seed=13)
    _, fi = flat.search(q, 10)
    r_plain = _recall(plain.search(q, 10, n_probe=16)[1], fi)
    r_ref = _recall(ref.search(q, 10, n_probe=16)[1], fi)
    assert r_ref >= r_plain and r_ref >= 0.95, (r_plain, r_ref)


def test_ivf_refine_save_load_bit_equal(tmp_path, flat32):
    e, flat = flat32
    ivf = TIVF.from_flat(flat, n_lists=16, n_probe=16, iters=10,
                         storage="sq8", refine=True)
    ivf.save(str(tmp_path / "ivfr"), n_files=4)
    idx2 = TIVF.load(str(tmp_path / "ivfr"), device="cpu")
    assert idx2.refine and idx2.list_rows_f16 is not None
    q = np.random.default_rng(17).standard_normal((4, 32)).astype(np.float32)
    s1, i1 = ivf.search(q, 8, n_probe=16)
    s2, i2 = idx2.search(q, 8, n_probe=16)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())


@pytest.mark.parametrize("dtype", ["hybrid", "int8r"])
def test_hybrid_and_int8r_with_ivf_mode(flat32, dtype):
    """--index_dtype hybrid/int8r with an IVF mode: sq8 and the fp16
    rescore; at full probe the top-1 is the fp16-exact argmax."""
    e, flat = flat32
    ivf = TIVF(len(e), 32, dtype, device="cpu", n_lists=16, n_probe=16)
    assert ivf.refine and ivf.storage == "sq8"
    assert ivf.dtype == torch.bfloat16
    ivf.train(e, iters=5)
    q = _near(e, 8, seed=23, noise=0.02)
    _, vi = ivf.search(q, 5, n_probe=16)
    oracle = np.argmax(q @ e.astype(np.float16).astype(np.float32).T, axis=1)
    assert (vi[:, 0].numpy() == oracle).all()


def test_dtype_and_storage_mapping_matches_jax(mesh1):
    for dtype, storage in (("int8", "dense"), ("int8", "pq"),
                           ("float16", "dense"), ("bfloat16", "sq8"),
                           ("float32", "pq"), ("hybrid", "dense"),
                           ("int8r", "pq")):
        jd = {"int8": jnp.int8, "float16": jnp.float16,
              "bfloat16": jnp.bfloat16, "float32": jnp.float32}.get(
                  dtype, dtype)
        j = JIVF(mesh1, 100, 32, dtype=jd, storage=storage)
        t = TIVF(100, 32, dtype, device="cpu", storage=storage)
        assert (t.storage, t.refine, t.n_lists, t.n_probe) == (
            j.storage, j.refine, j.n_lists, j.n_probe)
        assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name
    with pytest.raises(ValueError, match="divide"):
        TIVF(100, 30, device="cpu", storage="pq", code_size=8)
    with pytest.raises(ValueError, match="storage"):
        TIVF(100, 32, device="cpu", storage="ivf")


def test_build_index_for_maps_the_faiss_flags():
    def opt(**kw):
        return Options(device="cpu", **kw)

    idx = build_index_for(opt(index_mode="faiss", faiss_index_type="ivfpq",
                              faiss_code_size=8), 100, 32, device="cpu")
    assert isinstance(idx, TIVF)
    assert idx.storage == "pq" and idx.code_size == 8
    assert build_index_for(opt(index_mode="faiss", faiss_index_type="ivfsq"),
                           100, 32, device="cpu").storage == "sq8"
    assert build_index_for(opt(index_mode="faiss",
                               faiss_index_type="ivfflat",
                               index_dtype="bfloat16"),
                           100, 32, device="cpu").storage == "dense"
    # the int8r default with ivfflat: sq8 and the rescore, as in JAX
    ivf8 = build_index_for(opt(index_mode="faiss",
                               faiss_index_type="ivfflat"), 100, 32,
                           device="cpu")
    assert (ivf8.storage, ivf8.refine) == ("sq8", True)
    assert isinstance(build_index_for(opt(index_mode="faiss",
                                          faiss_index_type="flat"),
                                      100, 32, device="cpu"), TFlat)
    idx4 = build_index_for(opt(index_mode="faiss", faiss_index_type="pq",
                               faiss_code_size=8), 100, 32, device="cpu")
    assert idx4.storage == "pq" and idx4.n_lists == idx4.n_probe == 1
    idx5 = build_index_for(opt(index_mode="ivf", ivf_n_lists=20,
                               ivf_n_probe=3, ivf_refine=True,
                               index_dtype="int8", refine_r=6), 400, 32,
                           device="cpu")
    assert (idx5.storage, idx5.n_lists, idx5.n_probe, idx5.refine,
            idx5.refine_r) == ("sq8", 20, 3, True, 6)


def test_finalize_trains_the_staged_rows(flat32):
    """The build pipeline: set_embeddings stages f32 row blocks, finalize
    clusters them and frees the staging buffer."""
    e, flat = flat32
    ivf = TIVF(len(e), 32, "float32", device="cpu", n_lists=16, n_probe=16)
    for s in range(0, len(e), 300):
        ivf.set_embeddings(s, e[s:s + 300])
    ivf.finalize(iters=5)
    assert ivf._staging is None and ivf.offsets[-1] == len(e)
    assert sorted(ivf.list_ids.tolist()) == list(range(len(e)))
    q = _near(e, 4, seed=31)
    np.testing.assert_allclose(ivf.search(q, 5)[0].numpy(),
                               flat.search(q, 5)[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(RuntimeError, match="set_embeddings"):
        ivf.finalize()


# ------------------------------------------------------------------ approx
@pytest.mark.parametrize("k", [20, 32, 33, 64, 100])
def test_approx_matches_jax_approx_max_k(k):
    """The JAX approximate scan on the CPU returns ``lax.top_k``'s ids; the
    port's exact per-chunk selection returns the same, with k below, at and
    above half the chunk width and a ragged tail (1,000 rows in chunks of
    64)."""
    rng = np.random.default_rng(k)
    e = rng.standard_normal((1000, 24)).astype(np.float32)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    js, ji = jmips.mips_topk_approx(jnp.asarray(q), jnp.asarray(e), k,
                                    chunk=64)
    ts, ti = tmips.mips_topk_approx(torch.from_numpy(q), torch.from_numpy(e),
                                    k, chunk=64)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    # off the TPU even a loose target selects exactly
    _, ji_half = jmips.mips_topk_approx(jnp.asarray(q), jnp.asarray(e), k,
                                        chunk=64, recall_target=0.5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji_half))
    ts2, ti2 = tmips.mips_topk(torch.from_numpy(q), torch.from_numpy(e), k,
                               method="approx", chunk=64)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ji))
    # the column dispatcher, with a valid count masking the last 37 rows
    jcs, jci = jmips.mips_topk_xla_t(jnp.asarray(q), jnp.asarray(e.T), k,
                                     chunk=64, approx=True, valid_n=963)
    tcs, tci = tmips.mips_topk_t(torch.from_numpy(q), torch.from_numpy(e), k,
                                 method="approx", chunk=64, valid_n=963)
    np.testing.assert_array_equal(tci.numpy(), np.asarray(jci))
    np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), rtol=1e-5,
                               atol=1e-5)


def test_approx_over_fp16_and_bf16_rows_and_its_recall_target():
    rng = np.random.default_rng(3)
    e = rng.standard_normal((700, 16)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    for rows in (torch.from_numpy(e).half(), torch.from_numpy(e).bfloat16()):
        _, want = tmips.mips_topk_exact(q, rows, 10)
        _, got = tmips.mips_topk(q, rows, 10, method="approx",
                                 recall_target=0.5)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        _, got_t = tmips.mips_topk_t(q, rows, 10, method="approx")
        np.testing.assert_array_equal(got_t.numpy(), want.numpy())
    with pytest.raises(ValueError, match="recall_target"):
        tmips.mips_topk_approx(q, torch.from_numpy(e), 10, recall_target=0)


# ------------------------------------------------ RAG model and training
def test_retrieve_pair_over_ivf_takes_two_searches_as_jax(tmp_path, mesh1):
    """Over an IVF index at n_probe 1 the port's ``retrieve_pair`` returns
    the JAX package's prior and posterior ids (two searches, posterior
    first), where one search of the concatenated 2B queries would not: the
    posterior query probes the list holding the prior query's best row.
    The rows and query embeddings are made by hand (the tiny random towers
    embed every text alike); both models read the JAX-saved index."""
    from test_torch_train import _pair, _share_vocab

    (_, _, jmodel, jparams, _, _, _, tmodel, tparams, _, _) = _pair(
        tmp_path, "float32")
    _share_vocab(jmodel, tmodel)
    h = jmodel.retriever.cfg.bert.hidden
    rng = np.random.default_rng(0)
    n = len(jmodel.store)
    u, v = np.eye(h, dtype=np.float32)[:2]
    rows = np.where(np.arange(n)[:, None] % 2 == 0, 0.8 * u, v)
    rows = (rows + 0.01 * rng.standard_normal((n, h))).astype(np.float32)
    rows[5] += 0.9 * u  # a row of v's list that the prior query prefers
    j = JIVF(mesh1, n, h, dtype=jnp.float32, n_lists=2, n_probe=1)
    j.train(jnp.asarray(rows), key=jax.random.PRNGKey(0), iters=5)
    j.save(str(tmp_path / "ivf2"), n_files=2)
    t = load_index(str(tmp_path / "ivf2"), device="cpu")
    q_prior, q_post = (u + 0.1 * v)[None], v[None]
    jmodel.embed_queries = lambda p, texts, posterior=False: jnp.asarray(
        q_post if posterior else q_prior)
    tmodel.embed_queries = lambda p, texts, posterior=False: \
        torch.from_numpy(q_post if posterior else q_prior)
    jpair = jmodel.retrieve_pair(j, jparams, ["q"], ["q [SEP] a"], 3)
    tpair = tmodel.retrieve_pair(t, tparams, ["q"], ["q [SEP] a"], 3)
    for a, b in zip(jpair[:2], tpair[:2]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert tpair[2] == jpair[2] and tpair[3] == jpair[3]
    assert 5 not in tpair[0][0]
    _, both = t.search(torch.from_numpy(np.concatenate([q_prior, q_post])),
                       3)
    assert both[0, 0] == 5  # one 2B search would hand the prior row 5


def test_two_jsa_steps_over_full_probe_ivf_match_jax(tmp_path, monkeypatch):
    """Two jsa steps of the JAX loop and of the port's over the same dense
    f32 IVF directory (built and saved by the JAX package) at full probe,
    which is exact search whatever the k-means did: the same losses."""
    from jsa_rag_tpu.train import loop as jloop
    from jsa_rag_tpu.train import optim as joptim
    from jsa_rag_tpu.train import step as jstep
    from jsa_rag_tpu_torch.train import loop as tloop
    from jsa_rag_tpu_torch.train import modes as tmodes
    from jsa_rag_tpu_torch.train import optim as toptim
    from test_torch_train import _metrics, _pair, _share_vocab

    (jopt, mesh, jmodel, jparams, jindex, path, topt, tmodel, tparams,
     tindex, _) = _pair(tmp_path, "float32", index_mode="ivf",
                        ivf_n_lists=8, ivf_n_probe=8, total_steps=2)
    assert isinstance(jindex, JIVF) and isinstance(tindex, TIVF)
    assert tindex.n_probe == tindex.n_lists == 8
    jopt.load_index_path = path
    jparams, specs = jstep.setup_params(jopt, jparams, mesh)
    jtx, _ = joptim.set_optim(jopt, jparams)
    state = jstep.init_opt_state(jtx, jparams, specs, mesh)
    _, _, jsteps = jloop.train(jmodel, jindex, jparams, jtx, state, jopt,
                               mesh=mesh)
    assert jsteps == 2
    jdir = tmp_path / "ck" / "run"
    draws = []
    for s in (1, 2):
        with open(jdir / f"training_info_step{s}.json") as f:
            info = json.load(f)
        draws.append((np.asarray(info["debug/proposal_ids"], np.int64),
                      np.asarray(info["debug/uniform_draws"], np.float32)))

    def replay(gen, post, n):
        p, u = draws.pop(0)
        return torch.from_numpy(p[:, None]), torch.from_numpy(u[:, None])

    monkeypatch.setattr(tmodes, "draw_mis", replay)
    _share_vocab(jmodel, tmodel)
    topt.name = "torch"
    topt.load_index_path = path
    tx = toptim.set_optim(topt, tparams)
    assert tloop.train(tmodel, tindex, tparams, tx, topt) == 2
    jm = _metrics(jdir / "metrics.jsonl")
    tm = _metrics(tmp_path / "ck" / "torch" / "metrics.jsonl")
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == [1, 2]
    for a, b in zip(tm, jm):
        for k in ("loss/train_loss", "loss/generator_loss", "accept_rate"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_ivf_sweep_rows(capsys):
    """``analysis.ivf_sweep`` on the CPU at a tiny size: one JSON row per
    storage and n_probe; recall does not fall as n_probe rises; at full
    probe dense and the refines reach 0.99 and pq + refine beats pq."""
    from jsa_rag_tpu_torch.analysis import ivf_sweep

    rows = ivf_sweep.main(["--device", "cpu", "--n", "6000", "--d", "32",
                           "--clusters", "64", "--queries", "32", "--k",
                           "20", "--code_size", "8", "--n_lists", "40",
                           "--n_probes", "1,4,40"])
    assert len(capsys.readouterr().out.strip().splitlines()) == 15
    by = {(r["storage"], r["n_probe"]): r["recall@20"] for r in rows}
    for name in ivf_sweep.STORAGES:
        assert by[(name, 1)] <= by[(name, 4)] <= by[(name, 40)] + 1e-9
    for name in ("dense", "sq8+refine", "pq+refine"):
        assert by[(name, 40)] >= 0.99, (name, by[(name, 40)])
    assert by[("pq+refine", 40)] >= by[("pq", 40)]
    pq = next(r for r in rows if r["storage"] == "pq")
    assert pq["bytes_per_vec"] == 8 and set(pq["build_s"]) == {
        "kmeans", "codebooks", "encode_scatter", "total"}
    with pytest.raises(ValueError, match="unknown storages"):
        ivf_sweep.main(["--device", "cpu", "--storages", "ivfpq"])


@pytest.mark.parametrize("finalize", [True, False])
def test_build_index_trains_the_quantiser_after_the_sweep(finalize):
    """``index/build.py::build_index`` stages an IVF index's rows through
    the sweep and, with ``finalize`` (the default), trains it after the
    last block, splitting ``runtime/indexing`` into embed and quantiser;
    without, the rows stay staged for a later ``finalize()``."""
    from jsa_rag_tpu_torch.data import PassageStore, SimpleTokenizer
    from jsa_rag_tpu_torch.index.build import build_index

    store = PassageStore.synthetic(64, seed=0)
    tok = SimpleTokenizer(max_vocab=500)

    def encode(ids, mask):  # one row per passage, a function of its tokens
        g = torch.Generator().manual_seed(int(ids[:, :4].sum()))
        return torch.randn((ids.shape[0], 16), generator=g)

    ivf = TIVF(64, 16, "float32", device="cpu", n_lists=4, n_probe=4)
    stats = build_index(ivf, store, encode, tok, batch_size=16,
                        max_length=16, finalize=finalize)
    if finalize:
        assert ivf._staging is None and ivf.offsets[-1] == 64
        assert set(stats) >= {"indexing/embed_s", "indexing/finalize_s"}
    else:
        assert ivf._staging is not None and ivf.list_rows is None
        assert "indexing/finalize_s" not in stats
        ivf.finalize(iters=3)
        assert sorted(ivf.list_ids.tolist()) == list(range(64))
