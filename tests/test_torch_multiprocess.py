"""Port parity over two processes: two gloo CPU processes on a free localhost
port, started with ``torchrun``'s environment contract
(``parallel/dryrun.py::start``), against the JAX package on a 2-device
virtual mesh in this process.

The JAX references are computed here; the workers import torch and the port
only, and write what they got under ``tmp_path``. Every worker runs under a
timeout of at most 60 s, so a desync fails instead of hanging.

- (a) ``ShardedFlatIndex`` in int8r, hybrid, float16 and bfloat16 over two
  shards of 600 rows (1,197 passages: rank 1 holds 597), filled in blocks
  with one across the shard boundary, then a write across it; ragged query
  batches (3 rows on rank 0, 5 on rank 1) at k = 10, and the 16-bit
  storages also at 700 (more than a shard holds). Ids and
  scores held to the JAX index on a (1, 2) mesh as
  ``tests/test_torch_flat_index.py`` holds them: scores within 1e-5, ids
  equal except among ties (f16 rows compare at that file's 1e-6). The
  two-rank int8r ``save`` loads in the JAX package and in a one-process
  port with the same stored codes.
- (b) One jsa and one rag step, dropout off, the JAX run's MIS draws
  replayed, 2 rows a rank, against ``make_train_step`` on a (data=2) mesh
  over the same 4-row global batch: the loss (the ranks' mean) within 1e-5
  relative, the aux within 1e-4 relative and 1e-6 absolute, the updated
  params within 1e-5 absolute (``tests/test_torch_train.py``'s tolerances:
  float32 sums in another order, then Adam's normalised update), and the
  two replicas bit-equal.
- (c) ``evaluate``'s ``main`` over 5 questions in batches of 2 (the data
  iterator deals example i to rank (i + 1) % 2, so rank 1 has three
  questions in two batches and rank 0 two in one, then a dummy) against
  the JAX ``evaluate`` over an index on the (1, 2) mesh: the same metrics (eval loss within 1e-4
  relative), every question once in rank 0's merged predictions file with
  the JAX answer and passages; ``WeightedAvgStats`` with divergent key sets
  and ``weighted_average`` (2.5 / 4.0, the values the JAX package's own
  two-process test asserts, ``tests/test_multiprocess.py:52-56``),
  ``global_max_len`` and the any-rank OR.
- (d) ``parallel/dryrun.py``'s step over two processes.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu import model_io as jmodel_io
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.data.passages import load_passages_jsonl
from jsa_rag_tpu.evaluation import evaluate as jevaluate
from jsa_rag_tpu.index import build_index_for as jbuild_index_for
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.train import modes as jmodes
from jsa_rag_tpu.train import optim as joptim
from jsa_rag_tpu.train import step as jstep
from jsa_rag_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TorchIndex
from jsa_rag_tpu_torch.parallel import dryrun

from test_torch_mips import _unit_rows, assert_same_topk
from test_torch_train import _flat, _kw

TIMEOUT = 60
ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
N, D = 1197, 32
STORAGES = {"int8r": "int8r", "hybrid": "hybrid", "float16": jnp.float16,
            "bfloat16": jnp.bfloat16}
TOLS = {"int8r": 1e-5, "hybrid": 1e-6, "float16": 1e-6, "bfloat16": 1e-5}
# k above a shard's rows for the dense storages; the int8 ones stay at 10,
# where the JAX kernel's interpret mode compiles in seconds (minutes at 100)
KS = {"int8r": (10,), "hybrid": (10,), "float16": (10, 700),
      "bfloat16": (10, 700)}

WORKER_A = r"""
import json, os, sys
import numpy as np, torch
from jsa_rag_tpu_torch.parallel import mesh
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
from jsa_rag_tpu_torch.data import prompts
from jsa_rag_tpu_torch.utils.stats import WeightedAvgStats, weighted_average
torch.set_num_threads(1)
out_dir = sys.argv[1]
cfg = json.load(open(os.path.join(out_dir, "a.json")))
mesh.init_processes("cpu")
r = mesh.process_index()
rows = np.load(os.path.join(out_dir, "rows.npy"))
over = np.load(os.path.join(out_dir, "over.npy"))
q = np.load(os.path.join(out_dir, "queries.npy"))
mine = q[:3] if r == 0 else q[3:]
got = {}
for storage in cfg["storages"]:
    idx = ShardedFlatIndex(len(rows), rows.shape[1], storage, device="cpu")
    for s in range(0, len(rows), cfg["block"]):
        idx.set_embeddings(s, rows[s:s + cfg["block"]])
    idx.set_embeddings(cfg["over_at"], over)
    got[f"{storage}/geometry"] = np.array(
        [idx.shard_rows, idx.n_padded, idx.row_offset, idx.local_rows])
    for k in cfg["ks"][storage]:
        s, i = idx.search(mine, k)
        got[f"{storage}/{k}/scores"] = s.numpy()
        got[f"{storage}/{k}/ids"] = i.numpy()
    if storage == "int8r":
        idx.save(os.path.join(out_dir, "saved_int8r"), n_files=3)
np.savez(os.path.join(out_dir, f"index_{r}.npz"), **got)
stats = WeightedAvgStats()
stats.update({"m": (float(r), 2.0)})
if r == 0:
    stats.update({"r0_only": (4.0, 2.0)})
empty = WeightedAvgStats()
if r == 1:
    empty.update({"r1_only": (3.0, 1.0)})
v, w = weighted_average(1.0 if r == 0 else 3.0, 1.0 if r == 0 else 3.0)
res = {"stats": stats.average_stats, "empty": empty.average_stats,
       "weighted": [v, w], "max_len": prompts.global_max_len(5 + 7 * r),
       "any_none": mesh.any_rank(False), "any_one": mesh.any_rank(r == 1)}
with open(os.path.join(out_dir, f"stats_{r}.json"), "w") as f:
    json.dump(res, f)
from jsa_rag_tpu_torch.evaluate import main
metrics = main(cfg["eval_argv"])
with open(os.path.join(out_dir, f"eval_{r}.json"), "w") as f:
    json.dump(metrics, f)
mesh.shutdown_processes()
"""

WORKER_B = r"""
import json, os, pickle, sys
import numpy as np, torch
from jsa_rag_tpu_torch import config as tconfig, convert
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore
from jsa_rag_tpu_torch.parallel import mesh
from jsa_rag_tpu_torch.train import modes as tmodes
from jsa_rag_tpu_torch.train.optim import set_optim
from jsa_rag_tpu_torch.train.step import make_train_step, sync_params
torch.set_num_threads(1)
out_dir = sys.argv[1]
mesh.init_processes("cpu")
r = mesh.process_index()
for mode in ("jsa", "rag"):
    with open(os.path.join(out_dir, f"{mode}.pkl"), "rb") as f:
        ref = pickle.load(f)
    topt = tconfig.Options(device="cpu", **ref["kw"])
    model, _, _ = tmodel_io.load_or_initialize_model(
        topt, PassageStore.from_jsonl(topt.passages))
    params = convert.params_from_numpy(ref["init"], model.retriever.cfg)
    tx = set_optim(topt, params)
    sync_params(tx.leaves)
    b = ref["rows"]
    batch = {}
    for k, v in ref["batch"].items():
        per = v.shape[0] // (2 * b)
        batch[k] = torch.from_numpy(np.array(v[r * b * per:(r + 1) * b * per]))
    if "proposals" in ref:
        p = ref["proposals"][:, r * b:(r + 1) * b].astype(np.int64)
        u = np.array(ref["uniforms"][:, r * b:(r + 1) * b])
        tmodes.draw_mis = lambda gen, post, n: (torch.from_numpy(p),
                                                torch.from_numpy(u))
    step = make_train_step(model, mode, tx)
    loss, aux = step(params, batch, tmodes.StepRng.from_seed(0, "cpu"))
    out = {"loss": float(loss),
           "aux": {k: float(v) for k, v in aux.items()
                   if not k.startswith("debug/")},
           "buckets": step.reducer.buckets,
           "params": convert.params_to_numpy(params)}
    with open(os.path.join(out_dir, f"{mode}_{r}.pkl"), "wb") as f:
        pickle.dump(out, f)
mesh.shutdown_processes()
"""


def _check(results):
    for r in results:
        assert r.returncode == 0, r.stderr[-4000:]


# ------------------------------------------------------- the JAX references
def _eval_setup(root):
    """A JAX checkpoint (tiny, a non-zero LoRA adapter), 24 passages, 5
    questions; -> (argv, JAX metrics, JAX predictions)."""
    passages = [{"id": str(i), "title": f"e{i}",
                 "text": f"e{i} has value v{i}"} for i in range(24)]
    (root / "passages.jsonl").write_text(
        "".join(json.dumps(p) + "\n" for p in passages))
    (root / "dev.jsonl").write_text("".join(
        json.dumps({"question": f"value of e{i}", "answers": [f"v{i}"]})
        + "\n" for i in (1, 7, 12, 18, 23)))
    argv = ["--model_size", "tiny", "--precision", "fp32", "--task", "qa",
            "--n_context", "2", "--text_maxlength", "96",
            "--target_maxlength", "8", "--generation_max_length", "4",
            "--per_gpu_batch_size", "2", "--max_vocab", "600",
            "--index_dtype", "float32", "--lora_rank", "4",
            "--passages", str(root / "passages.jsonl"),
            "--eval_data", str(root / "dev.jsonl"),
            "--checkpoint_dir", str(root / "out"), "--write_results", "true"]
    jopt = jconfig.Options.from_args(argv + ["--name", "jax"])
    store = JStore(passages=load_passages_jsonl(str(root /
                                                    "passages.jsonl")))
    model, params, _ = jmodel_io.load_or_initialize_model(jopt, store)
    rng = np.random.default_rng(0)
    params["lora"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), params["lora"])
    # whole vocabularies to restore: SimpleTokenizer numbers a new word
    # when it first meets it, and each rank meets its own questions first
    for tok in (model.retriever_tokenizer, model.generator_tokenizer):
        for p in passages:
            tok.tokenize(f"{p['title']} {p['text']} value of question: "
                         f"answer: <extra_id_0> title: context: v{p['id']}")
    jsave_checkpoint(str(root / "ckpt"), "run", 7, params, options=jopt,
                     tokenizer=model.generator_tokenizer,
                     retriever_tokenizer=model.retriever_tokenizer)
    mesh2 = make_mesh(1, 2, devices=jax.devices()[:2])
    index = JaxIndex(mesh2, len(store), model.retriever.cfg.bert.hidden,
                     dtype=jnp.float32)
    model.build_index(index, params)
    metrics = jevaluate(model, index, params, jopt, str(root / "dev.jsonl"))
    argv = argv + ["--name", "torch", "--device", "cpu", "--model_path",
                   str(root / "ckpt" / "run")]
    return argv, metrics, _predictions(root / "out" / "jax" /
                                       "dev.jsonl.jsonl")


def _predictions(path):
    """{query: (generation, passage ids)} of a predictions file, and its
    row count."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return len(rows), {r["query"]: (r["generation"],
                                    [p["id"] for p in r["passages"]])
                       for r in rows}


def _index_refs(root):
    """The rows, queries and the JAX index's results on a (1, 2) mesh."""
    rows = _unit_rows(N, D, seed=17)
    rng = np.random.default_rng(17)
    over = _unit_rows(12, D, seed=18)  # rows 594-605: across 600
    gold = np.array([5, 599, 700, 600, 1196, 300, 598, 1001])
    full = rows.copy()
    full[594:606] = over
    q = full[gold] + 0.01 * rng.standard_normal((8, D)).astype(np.float32)
    np.save(root / "rows.npy", rows)
    np.save(root / "over.npy", over)
    np.save(root / "queries.npy", q)
    mesh2 = make_mesh(1, 2, devices=jax.devices()[:2])
    want = {}
    for name, dtype in STORAGES.items():
        j = JaxIndex(mesh2, N, D, dtype=dtype)
        for s in range(0, N, 500):
            j.set_embeddings(s, rows[s:s + 500])
        j.set_embeddings(594, over)
        want[f"{name}/geometry"] = (j.shard_rows, j.n_padded)
        for k in KS[name]:
            s, i = j.search(jnp.asarray(q), k)
            want[f"{name}/{k}"] = (np.asarray(s), np.asarray(i))
        if name == "int8r":
            want["int8r/index"] = j
    return gold, want


def _train_refs(root, mode):
    """The JAX model, one global batch of 4 rows and one step of
    ``make_train_step`` on a (data=2) mesh; the inputs the workers need go
    to ``<mode>.pkl``."""
    sub = root / mode
    sub.mkdir()
    kw = _kw(sub, index_dtype="int8r", gold_score_mode=mode,
             per_gpu_batch_size=2)
    jopt = jconfig.Options(**kw)
    mesh1 = make_mesh(1, 1, devices=jax.devices()[:1])
    store = JStore.from_jsonl(jopt.passages)
    model, params, _ = jmodel_io.load_or_initialize_model(jopt, store)
    index = jbuild_index_for(jopt, len(store),
                             model.retriever.cfg.bert.hidden, mesh1)
    model.build_index(index, params)
    queries = [f"what is the value of e{i}" for i in (3, 17, 22, 40)]
    targets = [f"v{i}" for i in (3, 17, 22, 40)]
    batch = model.build_batch(mode, index, params, queries, targets)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)
    ref = {"kw": kw, "rows": 2, "batch": batch,
           "init": jax.tree_util.tree_map(np.array, params)}
    if mode == "jsa":
        seen = {}
        orig = jmodes.mis_chain

        def spy(rng_, post, prior, log_lm, **k):
            out = orig(rng_, post, prior, log_lm, **k)
            seen["p"] = np.asarray(out[2]["proposals"])
            seen["u"] = np.asarray(out[2]["uniforms"])
            return out

        jmodes.mis_chain = spy
        try:
            jmodes.jsa_loss(model.fns, params, batch, rng)
        finally:
            jmodes.mis_chain = orig
        ref["proposals"], ref["uniforms"] = seen["p"], seen["u"]
    with open(root / f"{mode}.pkl", "wb") as f:
        pickle.dump(ref, f)
    jopt.mesh_data = 2
    mesh2 = make_mesh(2, 1, devices=jax.devices()[:2])
    params, specs = jstep.setup_params(jopt, params, mesh2)
    tx, _ = joptim.set_optim(jopt, params)
    state = jstep.init_opt_state(tx, params, specs, mesh2)
    step = jstep.make_train_step(model.fns, mode, tx, mesh2)
    placed = jstep.make_batch_placer(mesh2)(batch)
    params, _, loss, aux = step(params, state, placed, rng)
    return {"loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()
                    if not k.startswith("debug/")},
            "params": _flat(jax.tree_util.tree_map(np.asarray, params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the index/stats/evaluate workers, compute the JAX references
    meanwhile, then run the training workers; -> (dir, references)."""
    root = tmp_path_factory.mktemp("mp")
    gold, index_want = _index_refs(root)
    argv, jmetrics, jpred = _eval_setup(root)
    with open(root / "a.json", "w") as f:
        json.dump({"storages": list(STORAGES), "ks": KS,
                   "block": 500, "over_at": 594, "eval_argv": argv}, f)
    procs_a = dryrun.start(WORKER_A, 2, env=ENV, args=(str(root),))
    train_want = {mode: _train_refs(root, mode) for mode in ("jsa", "rag")}
    _check(dryrun.launch(WORKER_B, 2, TIMEOUT, env=ENV, args=(str(root),)))
    _check(dryrun.wait(procs_a, TIMEOUT))
    return root, dict(gold=gold, index=index_want, metrics=jmetrics,
                      pred=jpred, train=train_want)


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("storage,k", [(s, k) for s in STORAGES
                                       for k in KS[s]])
def test_sharded_index_matches_jax(runs, storage, k):
    """Two shards, ragged batches of 3 and 5: each rank's rows of the JAX
    index's results on the same two shards."""
    root, want = runs
    got = [np.load(root / f"index_{r}.npz") for r in (0, 1)]
    shard_rows, n_padded = want["index"][f"{storage}/geometry"]
    for r, g in enumerate(got):
        assert g[f"{storage}/geometry"].tolist() == [
            shard_rows, n_padded, r * shard_rows,
            min(max(N - r * shard_rows, 0), shard_rows)]
    assert got[0][f"{storage}/{k}/ids"].shape == (3, k)
    assert got[1][f"{storage}/{k}/ids"].shape == (5, k)
    ts = np.concatenate([g[f"{storage}/{k}/scores"] for g in got])
    ti = np.concatenate([g[f"{storage}/{k}/ids"] for g in got])
    js, ji = want["index"][f"{storage}/{k}"]
    assert_same_topk(ts, ti, js, ji, tol=TOLS[storage])
    assert (ti[:, 0] == want["gold"]).all()
    assert ti.min() >= 0 and ti.max() < N


def test_two_rank_save_loads_in_both_packages(runs):
    """The two-rank int8r save holds the JAX index's stored codes; it loads
    in the JAX package and in a one-process port, which search alike."""
    root, want = runs
    path = str(root / "saved_int8r")
    mesh1 = make_mesh(1, 1, devices=jax.devices()[:1])
    j = JaxIndex.load(path, mesh1)
    t = TorchIndex.load(path, device="cpu")
    ref = want["index"]["int8r/index"]
    np.testing.assert_array_equal(np.asarray(j.res)[:N],
                                  np.asarray(ref.res)[:N])
    np.testing.assert_array_equal(
        np.asarray(j.embeddings)[:, :N],
        np.concatenate([np.asarray(ref.embeddings)[:, :ref.shard_rows],
                        np.asarray(ref.embeddings)[:, ref.shard_rows:]],
                       axis=1)[:, :N])
    np.testing.assert_array_equal(t.res[:N].numpy(), np.asarray(j.res)[:N])
    np.testing.assert_array_equal(t.embeddings[:N].numpy(),
                                  np.asarray(j.embeddings)[:, :N].T)
    q = np.load(root / "queries.npy")
    js, ji = j.search(jnp.asarray(q), 10)
    ts, ti = t.search(q, 10)
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=1e-5)


# ------------------------------------------------------------------ (b)
@pytest.mark.parametrize("mode", ["jsa", "rag"])
def test_data_parallel_step_matches_jax(runs, mode):
    """One step on two ranks of 2 rows against the JAX step over the
    4-row global batch on a (data=2) mesh; the replicas bit-equal."""
    root, want = runs
    ref = want["train"][mode]
    got = []
    for r in (0, 1):
        with open(root / f"{mode}_{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    assert got[0]["loss"] == got[1]["loss"] and got[0]["buckets"] >= 1
    np.testing.assert_allclose(got[0]["loss"], ref["loss"], rtol=1e-5)
    assert set(got[0]["aux"]) == set(ref["aux"])
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(got[0]["aux"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    p0, p1 = (_flat(g["params"]) for g in got)
    assert set(p0) == set(ref["params"])
    for p, v in ref["params"].items():
        np.testing.assert_array_equal(p0[p], p1[p], err_msg=str(p))
        np.testing.assert_allclose(p0[p], v, rtol=0, atol=1e-5,
                                   err_msg=str(p))


# ------------------------------------------------------------------ (c)
def test_ragged_evaluate_matches_jax(runs):
    """Rank 1 evaluates two batches, rank 0 one and a dummy: the JAX
    metrics on every rank, and rank 0's merged file holds each question
    once with the JAX answer and passages."""
    root, want = runs
    for r in (0, 1):
        with open(root / f"eval_{r}.json") as f:
            tmet = json.load(f)["dev.jsonl"]
        jmet = want["metrics"]
        for key in ("exact_match", "f1", "retrieval_recall", "BLEU-1"):
            assert tmet[key] == pytest.approx(jmet[key], rel=1e-12), key
        np.testing.assert_allclose(tmet["eval_loss"], jmet["eval_loss"],
                                   rtol=1e-4)
    n_rows, tpred = _predictions(root / "out" / "torch" / "dev.jsonl.jsonl")
    assert n_rows == len(tpred) == want["pred"][0] == 5
    assert tpred == want["pred"][1]
    assert not (root / "out" / "torch" / "tmp_dir").exists()


def test_cross_rank_reductions(runs):
    """The stats reductions on both ranks: key-union averages, the
    weighted average (2.5, total weight 4.0), the pad-length max and the
    any-rank OR."""
    root, _ = runs
    for r in (0, 1):
        with open(root / f"stats_{r}.json") as f:
            got = json.load(f)
        assert got["stats"] == {"m": pytest.approx(0.5),
                                "r0_only": pytest.approx(4.0)}
        assert got["empty"] == {"r1_only": pytest.approx(3.0)}
        assert got["weighted"] == [pytest.approx(2.5), pytest.approx(4.0)]
        assert got["max_len"] == 12
        assert got["any_none"] is False and got["any_one"] is True


# ------------------------------------------------------------------ (d)
def test_dryrun_step(capsys):
    """``python -m jsa_rag_tpu_torch.parallel.dryrun --nproc 2``: one
    jsa step through the production step over two gloo processes, the
    replicas equal."""
    old = dict(os.environ)
    os.environ.update(ENV)
    try:
        assert dryrun.main(["--nproc", "2", "--timeout",
                            str(TIMEOUT)]) == 0
    finally:
        os.environ.clear()
        os.environ.update(old)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["world"] == 2 and line["grid"] == [2, 1]
    assert line["replicas_equal"] and np.isfinite(line["loss"])
