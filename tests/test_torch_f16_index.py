"""Port parity of float16 flat storage: kernels B4/B5's plain versions and
``mips_topk_f16_t`` against the JAX package's ``mips_topk_pallas2_f16_t``
(Pallas interpret mode, as ``tests/test_mips.py`` runs it), ``mips_topk_t``
on fp16 rows against JAX's on int16 bits, and the float16
``ShardedFlatIndex``: build, search, save/load both ways, serving a
JAX-saved index, subnormal rows and the default dtype.

Routes. The port's side runs the plain versions of B4/B5 (CPU tensors);
``method="auto"`` on the CPU is the exact f32 scan over the stored fp16
values in both packages. The JAX side runs its Pallas kernels in interpret
mode where a test names ``pallas2``/the wrapper.

Tolerances.
- refine >= 1: both packages rescore the same fp16 values in f32 (HIGHEST
  einsum against an f32 einsum on the CPU): scores within 1e-6, ids equal
  except among tied scores. The coarse passes differ (JAX: bf16 query and
  rows; port: fp16 query against exact rows), which only changes which
  candidates reach the rescore; with refine 4 at these sizes both pools
  hold the top-k.
- refine 0: JAX's three bf16 passes drop q_l*x_l and round q_l to bf16,
  ~2^-16 relative, so scores agree within 2e-5 for unit rows, and ids are
  compared as sets where neighbouring scores lie within that bound.
- exact / auto on the CPU: the same f32 products over the same stored
  values, summed in another order: 1e-6.
- built rows: the two towers agree to 1e-5 (``test_torch_bert``), so an f32
  embedding that straddles an fp16 rounding point stores one ulp apart (or
  up to 1e-5 apart where an ulp is finer, |x| < 2^-6); that may happen in
  under 2% of cells.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.data.passages import PassageStore as JaxStore
from jsa_rag_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from jsa_rag_tpu.index.build import build_index as jax_build_index
from jsa_rag_tpu.index.build import make_encode_fn as jax_make_encode_fn
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.models.bert import BertConfig as JaxBertConfig
from jsa_rag_tpu.models.retriever import (DualEncoderRetriever as JaxRetriever,
                                          RetrieverConfig as JaxRetrieverConfig)
from jsa_rag_tpu.ops import mips as jmips
from jsa_rag_tpu.ops.mips_pallas2 import f16_to_bits, mips_topk_pallas2_f16_t
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.convert import retriever_params_from_numpy
from jsa_rag_tpu_torch.data import PassageStore, SimpleTokenizer
from jsa_rag_tpu_torch.index import build_index_for, load_index
from jsa_rag_tpu_torch.index.build import build_index, make_encode_fn
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TorchIndex
from jsa_rag_tpu_torch.models import (BertConfig, DualEncoderRetriever,
                                      RetrieverConfig)
from jsa_rag_tpu_torch.ops import mips as tmips
from jsa_rag_tpu_torch.ops import mips_topt as tp2
from jsa_rag_tpu_torch.serve.__main__ import main as serve_main
from jsa_rag_tpu_torch.serve.client import call_retrieve_api

from test_torch_mips import _unit_rows, assert_same_topk

REFINED_TOL = 1e-6
EXACT16_TOL = 2e-5


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


def _bits_t(e16: np.ndarray, n_alloc: int, pad_value: float = 100.0):
    """(N, d) fp16 rows -> the JAX store: (d, n_alloc) int16 bits, garbage
    in the padded columns (the valid count must mask them)."""
    n, d = e16.shape
    bits = np.full((d, n_alloc), np.float16(pad_value).view(np.int16))
    bits[:, :n] = np.asarray(f16_to_bits(jnp.asarray(e16))).T
    return bits


def _rows16(e16: np.ndarray, n_alloc: int, pad_value: float = 100.0):
    """The port's store of the same rows: (n_alloc, d) torch.float16."""
    rows = np.full((n_alloc, e16.shape[1]), pad_value, np.float16)
    rows[:e16.shape[0]] = e16
    return torch.from_numpy(rows)


def _f16_bits(idx):
    """Stored fp16 rows of either index as (n_passages, d) int16 bits."""
    n = idx.n_passages
    if isinstance(idx, JaxIndex):
        return np.asarray(idx.embeddings)[:, :n].T
    return idx.embeddings[:n].view(torch.int16).numpy()


# ------------------------------------------------------------- the wrapper
@pytest.mark.parametrize("refine", [0, 4])
@pytest.mark.parametrize("n,n_alloc,k", [(2900, 3072, 20),
                                         (104, 128, 100)])  # k > valid rows
def test_f16_wrapper_matches_jax_kernel(refine, n, n_alloc, k):
    """``mips_topk_f16_t`` (plain B4/B5) against ``mips_topk_pallas2_f16_t``
    in interpret mode on the same fp16 rows, at the same emit tile (256),
    with ``valid_n < N`` over garbage pad rows and ``pool_n``; with k above
    the valid rows every id is distinct and valid (the -1 sentinel never
    resurfaces through the rescore)."""
    rng = np.random.default_rng(n + refine)
    b, d = 5, 64
    e16 = _unit_rows(n, d, seed=n).astype(np.float16)
    q = _unit_rows(b, d, seed=n + 1)
    js, ji = mips_topk_pallas2_f16_t(
        jnp.asarray(q), jnp.asarray(_bits_t(e16, n_alloc)), k, valid_n=n,
        pool_n=n, tile_n=256, interpret=True, refine=refine)
    ts, ti = tp2.mips_topk_f16_t(torch.from_numpy(q), _rows16(e16, n_alloc),
                                 k, valid_n=n, pool_n=n, refine=refine)
    ts, ti = ts.numpy(), ti.numpy()
    assert ti.shape == (b, min(k, n)) and ti.min() >= 0 and ti.max() < n
    assert_same_topk(ts, ti, np.asarray(js), np.asarray(ji),
                     tol=REFINED_TOL if refine else EXACT16_TOL)
    # against the exact f32 scores over the stored values
    exact = q @ e16.astype(np.float32).T
    np.testing.assert_allclose(ts, np.take_along_axis(exact, ti, axis=1),
                               rtol=0, atol=1e-6)
    if k >= n // 2:
        assert all(len(set(row)) == k for row in ti)
    del rng


@pytest.mark.parametrize("method", ["pallas2", "exact", "auto"])
def test_mips_topk_t_f16_matches_jax(method):
    """``ops.mips.mips_topk_t`` on fp16 rows against JAX's on int16 bits:
    ``pallas2`` is the fused search with refine 4 (JAX in interpret mode),
    ``exact`` and ``auto`` (on the CPU) the f32 scan over the stored
    values."""
    n, n_alloc, d, b, k = 3000, 3072, 64, 6, 10
    e16 = _unit_rows(n, d, seed=5).astype(np.float16)
    rng = np.random.default_rng(5)
    gold = rng.integers(0, n, b)
    q = (e16[gold].astype(np.float32)
         + 0.05 * rng.standard_normal((b, d)).astype(np.float32))
    js, ji = jmips.mips_topk_t(jnp.asarray(q),
                               jnp.asarray(_bits_t(e16, n_alloc)), k,
                               method=method, valid_n=n, pool_n=n, refine=4)
    ts, ti = tmips.mips_topk_t(torch.from_numpy(q), _rows16(e16, n_alloc), k,
                               method=method, valid_n=n, pool_n=n, refine=4)
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=REFINED_TOL)
    assert (ti[:, 0].numpy() == gold).all()


def test_f16_query_planes_split():
    """The power-of-two scale makes max|q*s| land in [0.5, 1); q_h + 2^-11
    q_l reproduces q*s to 2^-22 of max|q*s|; a zero row keeps s = 1."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 96)).astype(np.float32)
    q[1] *= 1e-6  # fp16(q) alone would go subnormal
    q[2] *= 3e4
    q[3] = 0.0
    qh, ql, inv_s = tp2.f16_query_planes(torch.from_numpy(q), 2)
    assert qh.dtype == ql.dtype == torch.float16
    s = 1.0 / inv_s.numpy().astype(np.float64)
    assert (np.log2(s) == np.round(np.log2(s))).all() and s[3] == 1.0
    qs = q.astype(np.float64) * s[:, None]
    m = np.abs(qs).max(axis=1)
    assert ((m[:3] >= 0.5) & (m[:3] < 1.0)).all()
    recon = qh.double().numpy() + 2.0 ** -11 * ql.double().numpy()
    assert (np.abs(recon - qs).max(axis=1) <= 2.0 ** -22 * np.maximum(m, 1)
            ).all()
    qh1, none, inv_s1 = tp2.f16_query_planes(torch.from_numpy(q), 1)
    assert none is None and torch.equal(qh1, qh) and torch.equal(inv_s1,
                                                                  inv_s)


def test_subnormal_rows_scored_as_stored():
    """Rows whose components are fp16 subnormals (the JAX decode flushes
    them to zero; torch keeps them): B5's plain version equals the exact
    f32 product over the stored values, and the refine path (B4's plain
    version + rescore) returns the exact top-k over them."""
    n, d, b, k = 512, 32, 3, 8
    e = _unit_rows(n, d, seed=9)
    e[:128] *= 2e-5  # every component below fp16's 2^-14 normal range
    e16 = e.astype(np.float16)
    assert (np.abs(e16[:128]) < np.float16(2 ** -14)).all()
    assert (e16[:128] != 0).mean() > 0.9
    q = np.zeros((b, d), np.float32)
    q[:, :4] = 1.0
    q[1] *= -1
    rows = torch.from_numpy(e16)
    exact = torch.from_numpy(q) @ rows.float().T
    s, i = tp2.scan_topt_f16_plain(torch.from_numpy(q), rows, n, 128, 128)
    np.testing.assert_array_equal(s.permute(1, 0, 2).reshape(b, -1)
                                  .sort(dim=1).values.numpy(),
                                  exact.sort(dim=1).values.numpy())
    # the subnormal rows only: their exact top-k, found by the refine path
    ts, ti = tp2.mips_topk_f16_t(torch.from_numpy(q), rows[:128].contiguous(),
                                 k, refine=4)
    want = torch.topk(exact[:, :128], k, dim=1)
    np.testing.assert_array_equal(ts.numpy(), want.values.numpy())
    assert (ts[:, 0] != 0).all()


def test_f16_wrappers_refuse_what_they_cannot_take():
    q = torch.zeros((2, 16))
    e = torch.zeros((64, 16), dtype=torch.float16)
    for scan in (tp2.scan_topt_f16h, tp2.scan_topt_f16):
        with pytest.raises(TypeError):
            scan(q, e.to(torch.bfloat16), 64, 128, 4)
        with pytest.raises(TypeError):
            scan(q.double(), e, 64, 128, 4)
        with pytest.raises(ValueError):
            scan(q, e, 65, 128, 4)
        with pytest.raises(ValueError):
            scan(q, e.t().contiguous().t(), 64, 128, 4)
    with pytest.raises(TypeError, match="float16"):
        tmips.mips_topk_t(q, e.view(torch.int16), 3)


def test_cpu_f16_searches_never_launch_b4_b5():
    before = (tp2.scan_topt_f16h.launches, tp2.scan_topt_f16.launches)
    rng = np.random.default_rng(1)
    for refine in (0, 4):
        idx = TorchIndex(300, 16, device="cpu")
        idx.refine_r = refine
        idx.set_embeddings(0, rng.standard_normal((300, 16)).astype(
            np.float32))
        for method in ("auto", "pallas2"):
            idx.method = method
            s, i = idx.search(rng.standard_normal((3, 16)).astype(
                np.float32), 5)
            assert s.device.type == "cpu" and i.shape == (3, 5)
    assert (tp2.scan_topt_f16h.launches, tp2.scan_topt_f16.launches) == before


# ------------------------------------------------------------------ index
def test_default_dtype_is_float16_in_both_packages(mesh1):
    """``ShardedFlatIndex(n, d)`` stores float16 in both packages (the JAX
    class's default, ``flat.py:185``): the same stored bits and the same
    search results."""
    n, d, k = 700, 32, 9
    e = _unit_rows(n, d, seed=11)
    j = JaxIndex(mesh1, n, d)
    t = TorchIndex(n, d, device="cpu")
    assert j.store_f16_bits and t.dtype == torch.float16
    assert t.storage == "float16" and t.refine_r == 4
    for idx in (j, t):
        idx.set_embeddings(0, e)
    np.testing.assert_array_equal(_f16_bits(t), _f16_bits(j))
    rng = np.random.default_rng(11)
    gold = rng.integers(0, n, 5)
    q = e[gold] + 0.02 * rng.standard_normal((5, d)).astype(np.float32)
    js, ji = j.search(jnp.asarray(q), k)
    ts, ti = t.search(q, k)
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=REFINED_TOL)
    assert (ti[:, 0].numpy() == gold).all()


GEOM = dict(vocab_size=1200, hidden=32, layers=2, heads=4, intermediate=64,
            max_positions=64, pooling="cls_norm")


def test_built_f16_index_matches_jax(mesh1):
    """``build_index`` with the same tower weights fills float16 rows equal
    to the JAX package's bits, except a bounded share one ulp apart, and
    the two indexes search alike."""
    n = 300
    jstore, tstore = JaxStore.synthetic(n, seed=0), PassageStore.synthetic(
        n, seed=0)
    warm = JaxTokenizer(max_vocab=GEOM["vocab_size"])
    for text in jstore.texts():
        warm.tokenize(text)
    jtok = JaxTokenizer(vocab=warm.vocab, max_vocab=GEOM["vocab_size"],
                        frozen=True)
    ttok = SimpleTokenizer(vocab=warm.vocab, max_vocab=GEOM["vocab_size"],
                           frozen=True)
    jr = JaxRetriever(JaxRetrieverConfig(bert=JaxBertConfig(**GEOM)))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: (rng.normal(0.0, 0.05, x.shape)
                   + (1.0 if x.ndim == 1 else 0.0)).astype(np.float32),
        jr.init(jax.random.PRNGKey(0)))
    tr = DualEncoderRetriever(RetrieverConfig(bert=BertConfig(**GEOM)),
                              device="cpu")
    tr.load_state_dict(retriever_params_from_numpy(tree))
    jidx = JaxIndex(mesh1, n, GEOM["hidden"], dtype=jnp.float16)
    encode = jax_make_encode_fn(jr)
    kw = dict(batch_size=32, max_length=48, sort_window=4)
    jax_build_index(jidx, jstore, lambda i, m: encode(tree, i, m), jtok, **kw)
    tidx = TorchIndex(n, GEOM["hidden"], "float16", device="cpu")
    build_index(tidx, tstore, make_encode_fn(tr.eval()), ttok, **kw)
    got, want = _f16_bits(tidx), _f16_bits(jidx)
    assert (got != want).mean() < 0.02
    # one ulp, or the towers' 1e-5 where an ulp is finer than that
    a, b = got.view(np.float16), want.view(np.float16)
    ulp = np.spacing(np.abs(b)).astype(np.float32)
    assert (np.abs(a.astype(np.float32) - b.astype(np.float32))
            <= np.maximum(ulp, 1e-5)).all()
    q = tidx.embeddings_as_float()[[3, 77, 250]].numpy()
    js, ji = jidx.search(jnp.asarray(q), 10)
    ts, ti = tidx.search(q, 10)
    # one stored ulp (2^-11 relative) moves a unit-row score by < 1e-3
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=1e-3)


def test_f16_save_load_both_ways(mesh1, tmp_path):
    """JAX save -> port load and port save -> JAX load: the same meta (but
    ``n_files``), the same stored bits and the same searches."""
    n, d, k = 530, 16, 9
    e = _unit_rows(n, d, seed=59)
    j = JaxIndex(mesh1, n, d, dtype=jnp.float16)
    t = TorchIndex(n, d, "float16", device="cpu")
    for start in range(0, n, 200):
        j.set_embeddings(start, e[start:start + 200])
        t.set_embeddings(start, e[start:start + 200])
    j.save(str(tmp_path / "from_jax"), n_files=4)
    t.save(str(tmp_path / "from_torch"), n_files=3)
    metas = []
    for name in ("from_jax", "from_torch"):
        with open(tmp_path / name / "meta.json") as f:
            metas.append({k_: v for k_, v in json.load(f).items()
                          if k_ != "n_files"})
    assert metas[0] == metas[1]
    assert metas[1]["dtype"] == "int16" and metas[1]["store_f16_bits"]
    assert not metas[1]["store_hybrid"]
    t2 = load_index(str(tmp_path / "from_jax"), device="cpu")
    j2 = JaxIndex.load(str(tmp_path / "from_torch"), mesh1)
    assert t2.storage == "float16" and j2.store_f16_bits
    np.testing.assert_array_equal(_f16_bits(t2), _f16_bits(j))
    np.testing.assert_array_equal(_f16_bits(j2), _f16_bits(t))
    q = _unit_rows(4, d, seed=61)
    rs, ri = j.search(jnp.asarray(q), k)
    for idx in (t, t2):
        s, i = idx.search(q, k)
        assert_same_topk(s.numpy(), i.numpy(), np.asarray(rs),
                         np.asarray(ri), tol=REFINED_TOL)
    s, i = j2.search(jnp.asarray(q), k)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(ri))
    np.testing.assert_array_equal(t2.embeddings_as_float().numpy(),
                                  np.asarray(j.embeddings_as_float()))


def test_jax_saved_f16_index_served_by_the_port(mesh1, tmp_path):
    """A float16 index saved by the JAX package, served by
    ``python -m jsa_rag_tpu_torch.serve``'s ``main`` on the CPU: the same
    ids and scores as the JAX index's own search."""
    n, d = 200, 32
    e = _unit_rows(n, d, seed=21)
    j = JaxIndex(mesh1, n, d, dtype=jnp.float16)
    j.set_embeddings(0, e)
    j.save(str(tmp_path / "index"), n_files=3)
    with open(tmp_path / "passages.jsonl", "w") as f:
        for i in range(n):
            f.write(json.dumps({"id": str(i), "title": f"t{i}",
                                "text": f"body {i}"}) + "\n")
    srv = serve_main(["--index_path", str(tmp_path / "index"), "--passages",
                      str(tmp_path / "passages.jsonl"), "--port", "0",
                      "--device", "cpu"], block=False)
    try:
        assert srv.index.storage == "float16"
        rng = np.random.default_rng(3)
        gold = rng.integers(0, n, 5)
        q = e[gold] + 0.05 * rng.standard_normal((5, d)).astype(np.float32)
        docs, scores = call_retrieve_api(
            q, topk=10, url=f"http://127.0.0.1:{srv.port}")
    finally:
        srv.stop()
    ti = np.array([[int(x["id"]) for x in row] for row in docs])
    js, ji = j.search(jnp.asarray(q), 10)
    assert_same_topk(np.asarray(scores), ti, np.asarray(js), np.asarray(ji),
                     tol=REFINED_TOL)
    assert (ti[:, 0] == gold).all()


def test_index_dtype_options(tmp_path):
    """``build_index_for`` takes float16 (refine_r passed through);
    ``refine_gather`` has no effect; an unknown dtype is an error."""
    class Opt:
        index_mode, faiss_index_type, index_dtype = "flat", "flat", "float16"
        refine_gather, int8r_refine, refine_r = "rows", "rows", 0

    idx = build_index_for(Opt, 50, 8, device="cpu")
    assert idx.dtype == torch.float16 and idx.refine_r == 0
    assert idx.embeddings.shape == (56, 8)
    with pytest.raises(ValueError, match="float16"):
        TorchIndex(10, 8, dtype="float8", device="cpu")
