"""Port parity: ``--retrieve_with_rerank`` (the over-retrieve, the live
passage tower's re-embedding and the host re-sort) against the JAX
package's, in ``retrieve``, ``retrieve_pair`` and ``evaluate``; and
``--profile_steps``' trace.

Both packages run on the same weights (the JAX init converted to the port),
the same saved index and the same tokenizer vocab. The corpus repeats ten
passages, so the re-sort meets exact ties: both packages sort the same
host scores with ``np.argsort(-scores)``.

Tolerances: retrieved ids are equal, ties included; rerank scores agree to
1e-5 (float32 towers in another summation order); evaluate's metrics and
answers are equal, its eval loss to 1e-4 relative."""

import json

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
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
from jsa_rag_tpu_torch.evaluate import main as teval_main
from jsa_rag_tpu_torch.index import load_index
from jsa_rag_tpu_torch.train.__main__ import main as ttrain_main

PASSAGES = ([{"id": str(i), "title": f"e{i}", "text": f"e{i} has value v{i}"}
             for i in range(30)]
            + [{"id": str(30 + i), "title": f"e{i}",
                "text": f"e{i} has value v{i}"} for i in range(10)])
QUERIES = ["value of e3", "what is e17", "e7 has value", "v25 e25"]
TARGETS = ["v3", "v17", "v7", "v25"]


def _write(tmp_path):
    path = tmp_path / "passages.jsonl"
    path.write_text("".join(json.dumps(p) + "\n" for p in PASSAGES))
    return str(path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(jax model, params, index, port model, params, index): one init, one
    saved float32 index, one vocab."""
    tmp_path = tmp_path_factory.mktemp("rerank")
    kw = dict(model_size="tiny", precision="fp32", max_vocab=300,
              gold_score_mode="jsa", retrieve_with_rerank=True,
              n_to_rerank_with_retrieve_with_rerank=12, index_dtype="float32",
              text_maxlength=24, passages=[_write(tmp_path)], seed=0)
    jopt = jconfig.Options(**kw)
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jstore = JStore(passages=load_passages_jsonl(jopt.passages[0]))
    jmodel, jparams, _ = jmodel_io.load_or_initialize_model(jopt, jstore)
    # a posterior unlike the prior, so the posterior tower is exercised
    rng = np.random.default_rng(1)
    jparams["post_retriever"] = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.02 * rng.standard_normal(x.shape),
                                  x.dtype), jparams["post_retriever"])
    jindex = jbuild_index_for(jopt, len(jstore),
                              jmodel.retriever.cfg.bert.hidden, mesh)
    jmodel.build_index(jindex, jparams)
    path = str(tmp_path / "index")
    jindex.save(path, n_files=2)
    topt = tconfig.Options(device="cpu", **kw)
    tmodel, _, _ = tmodel_io.load_or_initialize_model(
        topt, TStore.from_jsonl(topt.passages))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), tmodel.retriever.cfg)
    for name in ("retriever_tokenizer", "generator_tokenizer"):
        jt, tt = getattr(jmodel, name), getattr(tmodel, name)
        tt.vocab, tt.inv = dict(jt.vocab), dict(jt.inv)
    return (jmodel, jparams, jindex, tmodel, tparams,
            load_index(path, device="cpu"))


@pytest.mark.parametrize("posterior", [False, True])
def test_retrieve_rerank_matches_jax(pair, posterior):
    """``retrieve`` under rerank: 12 candidates re-sorted by the live
    passage tower (the posterior's for posterior queries); the JAX ids
    (duplicated passages tie exactly) and scores to 1e-5."""
    jmodel, jparams, jindex, tmodel, tparams, tindex = pair
    queries = ([f"{q} [SEP] {t}" for q, t in zip(QUERIES, TARGETS)]
               if posterior else QUERIES)
    jids, jscores, jpass = jmodel.retrieve(jindex, jparams, queries, 6,
                                           posterior=posterior)
    tids, tscores, tpass = tmodel.retrieve(tindex, tparams, queries, 6,
                                           posterior=posterior)
    ties = [len(set(np.round(np.asarray(s), 6))) < len(s) for s in jscores]
    assert any(ties)  # the duplicated passages meet in the re-sort
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_allclose(tscores, np.asarray(jscores), rtol=1e-5,
                               atol=1e-5)
    assert tpass == jpass


def _count_searches(monkeypatch, index):
    calls = []
    real = index.search

    def search(q, k):
        calls.append(k)
        return real(q, k)

    monkeypatch.setattr(index, "search", search)
    return calls


def test_retrieve_pair_under_rerank_takes_two_searches(pair, monkeypatch):
    """``retrieve_pair`` under rerank takes two ``retrieve`` calls (two
    searches of the over-retrieve's 12) in both packages, with equal ids
    and passages."""
    jmodel, jparams, jindex, tmodel, tparams, tindex = pair
    post_q = [f"{q} [SEP] {t}" for q, t in zip(QUERIES, TARGETS)]
    jcalls = _count_searches(monkeypatch, jindex)
    tcalls = _count_searches(monkeypatch, tindex)
    jout = jmodel.retrieve_pair(jindex, jparams, QUERIES, post_q, 3)
    tout = tmodel.retrieve_pair(tindex, tparams, QUERIES, post_q, 3)
    assert jcalls == tcalls == [12, 12]
    for a, b in zip(jout[:2], tout[:2]):
        np.testing.assert_array_equal(b, np.asarray(a))
    assert tout[2:] == jout[2:]


def test_evaluate_under_rerank_matches_jax(tmp_path):
    """``evaluate`` under rerank (reached through ``retrieve``): a JAX
    checkpoint evaluated by both packages gives equal metrics and answers,
    the eval loss to 1e-4."""
    from jsa_rag_tpu.train.checkpoint import save_checkpoint

    passages = _write(tmp_path)
    (tmp_path / "dev.jsonl").write_text("".join(
        json.dumps({"question": f"value of e{i}", "answers": [f"v{i}"]})
        + "\n" for i in (1, 3, 5, 7, 33)))
    argv = ["--model_size", "tiny", "--precision", "fp32", "--task", "qa",
            "--n_context", "2", "--text_maxlength", "48",
            "--target_maxlength", "8", "--generation_max_length", "4",
            "--per_gpu_batch_size", "3", "--max_vocab", "600",
            "--index_dtype", "float32", "--lora_rank", "4",
            "--retrieve_with_rerank", "true",
            "--n_to_rerank_with_retrieve_with_rerank", "6",
            "--passages", passages, "--eval_data", str(tmp_path / "dev.jsonl"),
            "--checkpoint_dir", str(tmp_path / "out"),
            "--write_results", "true"]
    jopt = jconfig.Options.from_args(argv + ["--name", "jax"])
    store = JStore(passages=load_passages_jsonl(passages))
    model, params, _ = jmodel_io.load_or_initialize_model(jopt, store)
    for p in PASSAGES:  # a vocabulary to restore
        model.retriever_tokenizer.tokenize(f"{p['title']} {p['text']}")
    save_checkpoint(str(tmp_path / "ckpt"), "run", 3, params, options=jopt,
                    tokenizer=model.generator_tokenizer,
                    retriever_tokenizer=model.retriever_tokenizer)
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    index = JaxIndex(mesh, len(store), model.retriever.cfg.bert.hidden,
                     dtype=jnp.float32)
    model.build_index(index, params)
    jmet = jevaluate(model, index, params, jopt, str(tmp_path / "dev.jsonl"))
    tmet = teval_main(argv + ["--name", "torch", "--device", "cpu",
                              "--model_path",
                              str(tmp_path / "ckpt" / "run")])["dev.jsonl"]
    for key in ("exact_match", "f1", "retrieval_recall"):
        assert tmet[key] == jmet[key], key
    np.testing.assert_allclose(tmet["eval_loss"], jmet["eval_loss"],
                               rtol=1e-4)

    def predictions(name):
        with open(tmp_path / "out" / name / "dev.jsonl.jsonl") as f:
            rows = [json.loads(line) for line in f]
        return [(r["generation"], [p["_gid"] if "_gid" in p else p["id"]
                                   for p in r["passages"]]) for r in rows]

    assert predictions("torch") == predictions("jax")


def test_profile_steps_writes_a_trace(tmp_path):
    """Three rag steps on the CPU with ``--profile_steps 1-2`` and
    pipelined retrieval: a Chrome trace under ``<checkpoint>/profile``
    holding the three annotations; without the flag no trace."""
    passages = _write(tmp_path)
    (tmp_path / "train.jsonl").write_text("".join(
        json.dumps({"question": f"value of e{i}", "answers": [f"v{i}"]})
        + "\n" for i in range(8)))
    argv = ["--device", "cpu", "--model_size", "tiny", "--precision", "fp32",
            "--task", "qa", "--gold_score_mode", "rag", "--dropout", "0",
            "--n_context", "2", "--text_maxlength", "24",
            "--target_maxlength", "8", "--max_vocab", "300",
            "--index_dtype", "float32", "--pipeline_retrieval", "true",
            "--total_steps", "3", "--save_freq", "1000",
            "--passages", passages, "--train_data",
            str(tmp_path / "train.jsonl"), "--checkpoint_dir",
            str(tmp_path / "ck")]
    assert ttrain_main(argv + ["--name", "plain"]) == 3
    assert not (tmp_path / "ck" / "plain" / "profile").exists()
    assert ttrain_main(argv + ["--name", "prof", "--profile_steps",
                               "1-2"]) == 3
    traces = list((tmp_path / "ck" / "prof" / "profile").iterdir())
    assert [t.name for t in traces] == ["steps_1-2.pt.trace.json"]
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"retrieve+tokenize", "prefetch_retrieve", "train"} <= names
