"""The port's probes (``jsa_rag_tpu_torch/analysis/{refine_bench,
int8r_gap_probe,mips_tune}.py``) against the JAX functions their JAX
scripts time, on the CPU.

At n = 4,000 valid rows of 4,096 (the stores padded as the flat index pads
them), d = 128, B = 8, k = 10, every arm that returns a top-k gets the same
numpy stores and queries as the JAX wrapper its JAX arm calls
(``mips_topk_pallas2_t``, ``_f16_t``, ``_int8_t`` with and without a refine
and the residual plane, ``_f16_refine``, ``ShardedFlatIndex(int8r).search``),
which runs in Pallas interpret mode. Compared as ``tests/test_torch_mips.py``
compares: scores within 1e-5, ids equal except among tied scores (the emit
tile is 256 on both sides here, against the TPU's 2048; ROADMAP §C "Top-k
order"). Then the gap probe's layers chained give the wrapper's output bit
for bit, each main runs end to end on the CPU with a finite time an arm,
and the tile sweep covers exactly the pairs the kernels take."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.ops import mips_pallas2 as jp2
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.analysis import int8r_gap_probe, mips_tune
from jsa_rag_tpu_torch.analysis import refine_bench
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
from jsa_rag_tpu_torch.ops import mips_topt as mt

from test_torch_mips import _unit_rows, assert_same_topk

N, N_PAD, D, B, K, R = 4000, 4096, 128, 8, 10, 4
TILE_N = 256
CPU = ["--device", "cpu", "--n", "4096", "--d", "128", "--b", "8", "--k",
       "10", "--iters", "2"]


def _pad(a, rows=N_PAD):
    return np.concatenate([a, np.zeros((rows - a.shape[0], *a.shape[1:]),
                                       a.dtype)])


@pytest.fixture(scope="module")
def stores():
    """numpy stores of the same unit rows, each padded to N_PAD rows; the
    codes from the port's quantisers (the JAX package's, bit for bit,
    under jit)."""
    e = _unit_rows(N, D, seed=3)
    v1, s1, v2, s2 = (x.numpy() for x in mt.quantize_int8_residual(
        torch.from_numpy(e)))
    return {"e": e,
            "bf16": _pad(e.astype(jnp.bfloat16)),
            "f16": _pad(e.astype(np.float16)),
            "v1": _pad(v1), "s1": _pad(s1[:, 0])[None],
            "v2": _pad(v2), "s2": _pad(s2[:, 0])[None]}


@pytest.fixture(scope="module")
def queries(stores):
    rng = np.random.default_rng(5)
    gold = rng.integers(0, N, B)
    q = stores["e"][gold] + 0.05 * rng.standard_normal((B, D))
    ids = rng.integers(0, N, (B, R * K)).astype(np.int32)
    return q.astype(np.float32), ids


def _port_stores(s):
    t = torch.from_numpy
    return {"bf16": t(s["bf16"].astype(np.float32)).to(torch.bfloat16),
            "f16": t(s["f16"]), "int8": (t(s["v1"]), t(s["s1"])),
            "int8r": (t(s["v1"]), t(s["s1"]), t(s["v2"]), t(s["s2"]))}


def _jax_arms(s, k):
    """The JAX script's arms (``refine_bench.py:136-159``) on the stores,
    at the port's emit tile."""
    bits_t = jnp.asarray(s["f16"].view(np.int16).T)
    rows = jnp.asarray(s["f16"].view(np.int16))
    v1t, s1 = jnp.asarray(s["v1"].T), jnp.asarray(s["s1"])
    pool = dict(valid_n=N, pool_n=N, tile_n=TILE_N)
    nv = jnp.asarray([N], jnp.int32)  # as the script passes it
    return {
        "bf16": lambda q, _: jp2.mips_topk_pallas2_t(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(s["bf16"].T), k,
            valid_n=N, tile_n=TILE_N),
        "f16_refine": lambda q, _: jp2.mips_topk_pallas2_f16_t(
            jnp.asarray(q), bits_t, k, refine=R, **pool),
        "f16_exact": lambda q, _: jp2.mips_topk_pallas2_f16_t(
            jnp.asarray(q), bits_t, k, **pool),
        "rescore_only": lambda q, ids: jp2._f16_refine(
            jnp.asarray(q), bits_t, jnp.asarray(ids), k, nv),
        "rescore_sorted": lambda q, ids: jp2._f16_refine(
            jnp.asarray(q), bits_t, jnp.sort(jnp.asarray(ids), axis=1), k,
            nv),
        "int8_coarse": lambda q, _: jp2.mips_topk_pallas2_int8_t(
            jnp.asarray(q), v1t, s1, k, **pool),
        "int8_hybrid": lambda q, _: jp2.mips_topk_pallas2_int8_t(
            jnp.asarray(q), v1t, s1, k, refine=R, emb_rows=rows, **pool),
        "int8r": lambda q, _: jp2.mips_topk_pallas2_int8_t(
            jnp.asarray(q), v1t, s1, k, refine=R,
            res_rows=jnp.asarray(s["v2"]), res_scale=jnp.asarray(s["s2"]),
            **pool),
    }


@pytest.mark.parametrize("arm", ["bf16", "f16_refine", "f16_exact",
                                 "rescore_only", "rescore_sorted",
                                 "int8_coarse", "int8_hybrid", "int8r"])
def test_refine_bench_arm_matches_jax(stores, queries, arm):
    q, ids = queries
    table = refine_bench.methods(_port_stores(stores), N, K, R,
                                 torch.from_numpy(ids))
    assert set(table) == set(refine_bench.ARMS) - set(refine_bench.SAME_AS)
    ts, ti = table[arm](torch.from_numpy(q))
    js, ji = _jax_arms(stores, K)[arm](q, ids)
    assert ti.shape == (B, K) and int(ti.min()) >= 0 and int(ti.max()) < N
    assert_same_topk(ts.float().numpy(), ti.numpy(), np.asarray(js),
                     np.asarray(ji))


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def int8r_indexes(stores, mesh1):
    """The same rows in the port's and the JAX package's int8r flat index
    (both quantise them; the codes are the same)."""
    t = ShardedFlatIndex(N, D, "int8r", device="cpu")
    t.set_embeddings(0, stores["e"])
    j = JaxIndex(mesh1, N, D, dtype="int8r")
    j.set_embeddings(0, jnp.asarray(stores["e"]))
    return t, j


@pytest.mark.parametrize("arm", ["bf16_ref", "kernel", "shardmap", "index"])
def test_gap_probe_arm_matches_jax(stores, queries, int8r_indexes, arm):
    """``bf16_ref`` against ``mips_topk_pallas2_t``; ``kernel`` against
    ``mips_topk_pallas2_int8_t`` (refine 4, rows); ``shardmap`` and
    ``index`` against the JAX ``ShardedFlatIndex(int8r).search``."""
    q = queries[0]
    tindex, jindex = int8r_indexes
    bf16_rows = _port_stores(stores)["bf16"]
    table = int8r_gap_probe.methods(tindex, bf16_rows, torch.from_numpy(q),
                                    N, K)
    assert set(table) == set(int8r_gap_probe.ARMS)
    ts, ti = table[arm](torch.from_numpy(q))
    if arm in ("shardmap", "index"):
        js, ji = jindex.search(jnp.asarray(q), K)
    elif arm == "kernel":
        js, ji = jp2.mips_topk_pallas2_int8_t(
            jnp.asarray(q), jnp.asarray(tindex.embeddings.numpy().T),
            jnp.asarray(tindex.scales.numpy()), K, valid_n=N, pool_n=N,
            tile_n=TILE_N, refine=4,
            res_rows=jnp.asarray(tindex.res.numpy()),
            res_scale=jnp.asarray(tindex.res_scales.numpy()),
            int8r_refine="rows")
    else:
        js, ji = _jax_arms(stores, K)["bf16"](q, None)
    assert_same_topk(ts.float().numpy(), ti.numpy(), np.asarray(js),
                     np.asarray(ji))


def test_gap_probe_layers_chain_to_the_kernel(queries, int8r_indexes):
    """quantize -> scan -> merge -> refine, each fed the previous layer's
    output, gives the wrapper's scores and ids exactly."""
    q = torch.from_numpy(queries[0])
    idx = int8r_indexes[0]
    ops = (idx.embeddings, idx.scales, idx.res, idx.res_scales)
    layers, (s, i) = int8r_gap_probe.split_layers(q, ops, N, K)
    assert list(layers) == list(int8r_gap_probe.LAYERS)
    ws, wi = mt.mips_topk_int8_t(q, ops[0], ops[1], K, valid_n=N, pool_n=N,
                                 refine=4, res_rows=ops[2],
                                 res_scale=ops[3], int8r_refine="rows")
    assert torch.equal(s, ws) and torch.equal(i, wi)
    qv1, qs1, qv2, qs2 = layers["quantize"]()
    cand = layers["scan"]()
    vals, ids = layers["merge"]()
    assert torch.equal(torch.cat([qv1, qv2]), torch.cat(
        mt.quantize_int8_residual(q)[::2]))
    assert cand[0].shape[1] == B and ids.shape == (B, R * K)
    rs, ri = layers["refine"]()
    assert torch.equal(rs, ws) and torch.equal(ri, wi)


def _finite_positive(values):
    values = list(values)
    return bool(values) and all(math.isfinite(v) and v > 0 for v in values)


def test_refine_bench_main_on_the_cpu(capsys):
    r = refine_bench.main(CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(r))
    assert list(r["arms"]) == list(refine_bench.ARMS)
    assert len([ln for ln in lines if "ms/call" in ln]) == len(
        refine_bench.ARMS)
    assert _finite_positive(v for a in r["arms"].values()
                            for v in (a["ms"], a["qps"]))
    for arm, other in refine_bench.SAME_AS.items():
        assert r["arms"][arm] == {**r["arms"][other], "same_as": other}
    assert r["platform"] == "cpu"


def test_refine_bench_builds_only_the_stores_it_needs():
    assert refine_bench.stores_for(["int8_hybrid"]) == {"int8", "f16"}
    assert refine_bench.stores_for(["rescore_rows"]) == {"f16"}
    assert refine_bench.stores_for(["int8r", "bf16"]) == {"int8r", "bf16"}
    got = refine_bench.build_stores({"int8", "int8r"}, 300, 32, 0,
                                    torch.device("cpu"))
    assert set(got) == {"int8", "int8r"}
    assert got["int8"][0] is got["int8r"][0]


def test_gap_probe_main_on_the_cpu(capsys):
    r = int8r_gap_probe.main(CPU)
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    assert [x["arm"] for x in rows[:-1]] == list(int8r_gap_probe.ARMS)
    assert set(rows[0]) == {"arm", "qps", "ms_per_call", "n", "d", "b", "k",
                            "n_dev", "platform", "device"}
    assert _finite_positive(v for x in r["rows"]
                            for v in (x["qps"], x["ms_per_call"]))
    assert r["layer_sum_ms"] == pytest.approx(sum(
        x["ms_per_call"] for x in r["rows"]
        if x["arm"] in int8r_gap_probe.LAYERS))
    assert rows[-1]["kernel_ms"] == r["kernel_ms"]


def test_mips_tune_sweeps_exactly_the_valid_pairs(capsys):
    assert mips_tune.configs() == [(128, 2), (128, 4), (256, 2), (256, 4)]
    assert {tn for tn, _ in mips_tune.configs()} == set(mt.KERNEL_TILES)
    for layout in ("t", "row"):
        r = mips_tune.main([*CPU, "--layout", layout])
        assert [(c["tile_n"], c["t_per_tile"]) for c in r["configs"]] == \
            mips_tune.configs()
        assert _finite_positive(v for c in r["configs"]
                                for v in (c["qps"], c["ms"]))
        assert all(c["T"] >= c["t_per_tile"] for c in r["configs"])
        out = capsys.readouterr().out
        assert out.count("tile_n=") == 4 and "# best: " in out
