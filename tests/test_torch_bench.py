"""The port's benches on the CPU at a tiny size: ``python -m
jsa_rag_tpu_torch.bench`` (every method of its table) and ``python -m
jsa_rag_tpu_torch.analysis.storage_recall_bench`` (every mode), each run
through its ``main`` with ``--device cpu``, where every kernel wrapper
takes its plain version.

Bars: recall@100 against the exact f32 oracle over the original rows is
at least 0.99 for every bench method at this size (the refine and fp16
methods come out at 1.0; the bf16 stores and int8r ``rows1`` lose a
neighbour or two at the boundary, 0.994-0.998); ``pallas`` is the exact
top-k, so against an oracle over the stored bf16 values its recall is 1.0.

At 65,536 x 1024 the int8r methods are held to the JAX package's
``mips_topk_pallas2_int8_t`` (Pallas interpret mode) on the bench's corpus:
equal ids, hence equal recall; there ``rows1`` falls below 0.99 in both."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.ops import mips_pallas2 as jp2
from jsa_rag_tpu_torch import bench
from jsa_rag_tpu_torch.analysis import storage_recall_bench as srb
from jsa_rag_tpu_torch.ops import mips_topt as tp2
from jsa_rag_tpu_torch.ops.mips import mips_topk_exact

TINY = ["--device", "cpu", "--n", "4096", "--d", "64", "--b", "16",
        "--iters", "2"]
BENCH_KEYS = {"platform", "device", "metric", "value", "unit", "n", "d",
              "b", "k", "method", "recall@100", "matmul_floor_qps",
              "frac_of_floor"}


@pytest.mark.parametrize("method", sorted(bench.methods(1, 1)))
def test_bench_method_prints_one_line(method, capsys):
    res = bench.main([*TINY, "--method", method])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == res
    assert set(res) == BENCH_KEYS
    assert res["platform"] == "cpu" and res["method"] == method
    assert (res["n"], res["d"], res["b"], res["k"]) == (4096, 64, 16, 100)
    assert res["value"] > 0 and res["matmul_floor_qps"] > 0
    assert res["recall@100"] >= 0.99


def test_bench_default_is_the_options_storage(capsys):
    """No ``--method``: the method of ``Options().index_dtype`` (int8r,
    kernel B1 on the card), as ``bench.py:88-97`` derives it."""
    assert bench.default_method() == "int8r"
    res = bench.main(TINY)
    assert res["method"] == "int8r"
    capsys.readouterr()


def test_bench_pallas_is_exact_over_the_stored_rows():
    """The ``pallas`` method (kernel B9's plain version here) returns the
    exact top-100 of the bf16 query against the stored bf16 rows."""
    e = bench.seeded_rows(bench.unit_gaussian(64, torch.device("cpu")),
                          4096, 64, 0, torch.device("cpu"))
    index = bench.build_index("bfloat16", e)
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 64)).astype(np.float32))
    _, search = bench.methods(4096, 100)["pallas"]
    _, ids = search(q, index)
    _, oracle = mips_topk_exact(q.to(torch.bfloat16), index.embeddings, 100)
    assert bench.recall_at(ids, oracle, 100) == 1.0


@pytest.mark.parametrize("index_dtype", ["int8r", "int8", "hybrid",
                                         "float16", "bfloat16", "float32"])
def test_every_index_dtype_has_a_default_method(index_dtype, capsys):
    """``default_method`` names a method of ``methods()`` for every
    ``--index_dtype`` (``int8`` maps to ``int8t``, which the JAX bench
    names but does not define), and the bench runs it."""
    from jsa_rag_tpu_torch.config import Options
    from jsa_rag_tpu_torch.index.flat import STORAGES

    assert index_dtype in STORAGES
    method = bench.default_method(Options(index_dtype=index_dtype))
    assert method in bench.methods(1, 1)
    if index_dtype == "int8":
        res = bench.main([*TINY, "--index_dtype", "int8"])
        assert res["method"] == "int8t" and res["recall@100"] >= 0.99
        capsys.readouterr()


def test_int8t_matches_jax_int8_search():
    """The bench's ``int8t`` (the plain int8 search over the int8 store,
    kernel B2 on the card) against the JAX package's
    ``mips_topk_pallas2_int8_t`` at refine 0 (Pallas interpret mode) on the
    bench's corpus recipe, both at 256-row tiles and the same T: the same
    ids, scores within 1e-5 relative (the same f32 dequant products)."""
    n, d, b, k = 4096, 64, 16, 100
    cpu = torch.device("cpu")
    e = bench.seeded_rows(bench.unit_gaussian(d, cpu), n, d, 0, cpu)
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, d)).astype(np.float32))
    v, s = jp2.quantize_int8(jnp.asarray(e.numpy()))
    js, jids = jp2.mips_topk_pallas2_int8_t(
        jnp.asarray(q.numpy()), v.T, s.reshape(1, -1), k, tile_n=256,
        t_per_tile=4, valid_n=n, pool_n=n, refine=0, interpret=True)
    storage, search = bench.methods(n, k)["int8t"]
    ts, ids = search(q, bench.build_index(storage, e))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("refine", ["rows", "rows1"])
def test_int8r_recall_on_the_bench_corpus_matches_jax(refine):
    """The bench's ``int8r`` and ``int8r_rows1`` searches against the JAX
    package's on the bench's own corpus recipe (seeded unit gaussian rows,
    gaussian queries from ``default_rng(0)``) at 65,536 x 1024, 64 queries,
    k = 100, both scanning 256-row tiles with the same T: the ids are equal,
    so the recall against the exact f32 oracle is too. ``rows`` finds every
    neighbour; ``rows1`` keeps the one-plane query's quantisation error in
    its final score (``mips_pallas2.py:937-939``) and loses ~1% of the
    boundary in both packages (0.9897 here; printed under ``pytest -s``)."""
    n, d, b, k = 65_536, 1024, 64, 100
    cpu = torch.device("cpu")
    e = bench.seeded_rows(bench.unit_gaussian(d, cpu), n, d, 0, cpu)
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (b, d)).astype(np.float32))
    _, oracle = mips_topk_exact(q, e, k)
    v1, s1, v2, s2 = jp2.quantize_int8_residual(jnp.asarray(e.numpy()))
    _, jids = jp2.mips_topk_pallas2_int8_t(
        jnp.asarray(q.numpy()), v1.T, s1.reshape(1, -1), k, tile_n=256,
        t_per_tile=4, valid_n=n, pool_n=n, refine=4, res_rows=v2,
        res_scale=s2.reshape(1, -1), int8r_refine=refine, interpret=True)
    index = bench.build_index("int8r", e)
    _, ids = tp2.mips_topk_int8_t(
        q, index.embeddings, index.scales, k, refine=4, res_rows=index.res,
        res_scale=index.res_scales, int8r_refine=refine, valid_n=n, pool_n=n)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    recall = bench.recall_at(ids, oracle, k)
    print(f"int8r {refine} recall@100 at {n} x {d}: {recall}")
    if refine == "rows":
        assert recall == 1.0
    else:
        assert 0.98 <= recall < 0.99


def test_bench_refuses_approx_and_cuda_without_a_card():
    """``approx`` runs now (the exact per-chunk top-k that ships as the JAX
    bench's method, recall 1 against the f32 oracle over the bf16 rows'
    originals at this size); an unknown method and a card that is not
    there still refuse."""
    res = bench.main([*TINY, "--method", "approx"])
    assert res["method"] == "approx" and res["recall@100"] >= 0.99
    with pytest.raises(ValueError, match="unknown bench method"):
        bench.main([*TINY, "--method", "int4t"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench.main(TINY[2:])  # the default device is cuda


def test_storage_bench_prints_one_row_per_mode(capsys):
    names = sorted(srb.modes(1, 1))
    rows = srb.main(["--device", "cpu", "--n", "3000", "--d", "32", "--b",
                     "8", "--iters", "1", "--clusters", "32", "--modes",
                     ",".join(names)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in lines] == rows
    assert [r["mode"] for r in rows] == names
    for r in rows:
        assert {"mode", "recall@20", "recall@100", "qps", "hbm_gb", "n",
                "d", "b", "k"} <= set(r)
        assert r["qps"] > 0 and 0.9 <= r["recall@100"] <= 1.0
    by_mode = {r["mode"]: r for r in rows}
    # the exact-precision stores find the oracle's neighbours
    for mode in ("f16_t", "f16_row", "int8r", "flat_f16_index"):
        assert by_mode[mode]["recall@100"] >= 0.99
    with pytest.raises(ValueError, match="unknown modes"):
        srb.main(["--device", "cpu", "--modes", "bf16_t,ivf"])
