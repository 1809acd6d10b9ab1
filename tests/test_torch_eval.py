"""Port parity: the evaluate path of ``jsa_rag_tpu_torch`` against the JAX
package on the CPU — options, prompt batches, the qa task and its metrics,
the dense index's saved format, a JAX-written checkpoint, and both packages'
``evaluate`` over the committed hard-copy demo.

Tolerances: host-side pieces (options, token batches, task outputs, metric
values) must be equal. Saved indexes store the same bits. End to end, both
packages compute in float32 and the outputs compared are discrete (retrieved
ids, decoded answers) or averages of them (EM, F1, recall), so they must be
equal; the eval loss agrees to 1e-4 relative."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu.data import prompts as jprompts
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.data.passages import load_passages_jsonl
from jsa_rag_tpu.data.tokenizer import SimpleTokenizer as JTok
from jsa_rag_tpu.evaluation import evaluate as jevaluate
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.tasks import get_task as jget_task
from jsa_rag_tpu.utils import metrics as jmetrics
from jsa_rag_tpu.utils.stats import WeightedAvgStats as JStats
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch.data import prompts as tprompts
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer as TTok
from jsa_rag_tpu_torch.evaluate import main as tmain
from jsa_rag_tpu_torch.evaluation import evaluate as tevaluate
from jsa_rag_tpu_torch.index import load_index
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TorchIndex
from jsa_rag_tpu_torch.tasks import get_task as tget_task
from jsa_rag_tpu_torch.utils import metrics as tmetrics
from jsa_rag_tpu_torch.utils.stats import WeightedAvgStats as TStats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(ROOT, "docs", "demo", "artifacts")


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


def _asdict(opt):
    d = dataclasses.asdict(opt)
    d.pop("device", None)
    return d


@pytest.mark.parametrize("argv", [
    [],
    ["--n_context", "4", "--eval_data", "a.jsonl", "b.jsonl",
     "--use_lora", "false", "--closed_book", "--generation_min_length",
     "none", "--load_index_path", "None", "--decoder_prompt_format",
     "{query}", "--lora_alpha", "4.5", "--index_dtype", "bfloat16"],
    ["--closed_book", "true", "--scheduler_steps", "7",
     "--retriever_pooling", "mean", "--generation_min_length", "3"],
])
def test_options_parse_like_jax(argv):
    j = jconfig.Options.from_args(argv)
    t = tconfig.Options.from_args(argv + ["--device", "cpu"])
    assert _asdict(t) == _asdict(j)
    assert t.device == "cpu"
    assert tconfig.Options.from_args(argv).device == "cuda"


QUERIES = ["what is the code for qw1 qw2", "who wrote <speaker1> it"]
PASSAGES = [[{"title": "pw1 pw2", "text": "the code is code7"},
             {"title": "t", "text": " ".join(f"w{i}" for i in range(90))}],
            [{"title": "", "text": "someone wrote it"},
             {"title": "x", "text": "short"}]]


@pytest.mark.parametrize("family,concat,dialog", [
    ("mistral", False, False), ("llama", True, False),
    ("gpt2", False, False), ("gpt2", True, False), ("gpt2", False, True)])
def test_prompt_batches_match_jax(family, concat, dialog):
    kw = dict(family=family, concat_doc=concat, dialog=dialog,
              text_maxlength=48, target_maxlength=8)
    jcfg, tcfg = jprompts.PromptConfig(**kw), tprompts.PromptConfig(**kw)
    jt, tt = JTok(max_vocab=400), TTok(max_vocab=400)
    targets = ["code7", "someone"]
    for a, b in zip(
            jprompts.build_generation_batch(jt, QUERIES, PASSAGES, jcfg),
            tprompts.build_generation_batch(tt, QUERIES, PASSAGES, tcfg)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(
            jprompts.build_training_batch(jt, QUERIES, PASSAGES, targets,
                                          jcfg),
            tprompts.build_training_batch(tt, QUERIES, PASSAGES, targets,
                                          tcfg)):
        np.testing.assert_array_equal(b, a)
    assert tt.vocab == jt.vocab
    assert [tprompts.remove_speakers(q) for q in QUERIES] == \
        [jprompts.remove_speakers(q) for q in QUERIES]


def test_qa_task_and_metrics_match_jax(tmp_path):
    opt_kw = dict(qa_prompt_format="question: {question} answer:")
    jtask = jget_task(jconfig.Options(**opt_kw), None)
    ttask = tget_task(tconfig.Options(device="cpu", **opt_kw), None)
    assert ttask.metrics == jtask.metrics
    rows = [{"question": "q one", "answers": ["The Answer"]},
            {"question": "q two", "target": "t", "passages": [{"x": 1}]},
            {"question": "q three", "answers": ["b"], "metadata": {"id": 3}}]
    path = tmp_path / "d.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    jex = [jtask.process(e) for e in jtask.data_iterator(str(path), 0, 1)]
    tex = [ttask.process(e) for e in ttask.data_iterator(str(path), 0, 1)]
    assert tex == jex
    jb = list(jtask.batch_iterator(iter(jex), 2))
    tb = list(ttask.batch_iterator(iter(tex), 2))
    assert [dict(b) for b in tb] == [dict(b) for b in jb]
    for pred, gold in [("the answer", ["The Answer"]), ("a b c", ["b c d"]),
                       ("", ["x"]), ("Answer.", ["answer", "no"])]:
        assert ttask.evaluation(pred, gold) == jtask.evaluation(pred, gold)
        for fn in ("exact_match_score", "f1_score"):
            assert getattr(tmetrics, fn)(pred, gold) == \
                getattr(jmetrics, fn)(pred, gold)
    texts = ["the code is code7", "nothing here"]
    assert tmetrics.recall(texts, ["CODE7", "x"]) == \
        jmetrics.recall(texts, ["CODE7", "x"])
    assert tmetrics.coverage_at_k(texts, ["here"], ks=(1, 2)) == \
        jmetrics.coverage_at_k(texts, ["here"], ks=(1, 2))
    js, ts = JStats(), TStats()
    for vals in ({"a": (1.0, 2.0)}, {"a": (4.0, 1.0), "b": (0.5, 3.0)}):
        js.update(vals)
        ts.update(vals)
    assert ts.average_stats == js.average_stats
    mc = dict(task="multiple_choice", multiple_choice_num_options=3)
    jmc = jget_task(jconfig.Options(**mc), None)
    tmc = tget_task(tconfig.Options(device="cpu", **mc), None)
    assert tmc.metrics == jmc.metrics
    assert tmc.choices == jmc.choices == "ABC"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_index_save_load_both_ways(mesh1, tmp_path, dtype):
    """JAX save -> port load and port save -> JAX load: the same stored
    values (bf16 as uint16 bits on disk), the same meta, the same
    results."""
    rng = np.random.default_rng(7)
    n, d, k = 530, 16, 9
    e = rng.standard_normal((n, d)).astype(np.float32)
    j = JaxIndex(mesh1, n, d, dtype=getattr(jnp, dtype))
    t = TorchIndex(n, d, dtype, device="cpu")
    j.set_embeddings(0, e)
    t.set_embeddings(0, e)
    j.save(str(tmp_path / "jax"), n_files=4)
    t.save(str(tmp_path / "torch"), n_files=3)
    metas = [json.loads((tmp_path / w / "meta.json").read_text())
             for w in ("jax", "torch")]
    for m in metas:
        m.pop("n_files")
    assert metas[0] == metas[1] and metas[0]["dtype"] == dtype
    if dtype == "bfloat16":
        assert np.load(tmp_path / "torch" / "embeddings.0.npy").dtype == \
            np.uint16
    t2 = load_index(str(tmp_path / "jax"), device="cpu", expected_dim=d)
    j2 = JaxIndex.load(str(tmp_path / "torch"), mesh1)
    want = np.asarray(j.embeddings_as_float())
    np.testing.assert_array_equal(t2.embeddings_as_float().numpy(), want)
    np.testing.assert_array_equal(np.asarray(j2.embeddings_as_float()), want)
    q = rng.standard_normal((4, d)).astype(np.float32)
    js, ji = j.search(jnp.asarray(q), k)
    ts, ti = t2.search(q, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    js2, ji2 = j2.search(jnp.asarray(q), k)
    np.testing.assert_array_equal(np.asarray(ji2), np.asarray(ji))


def _predictions(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return ([r["generation"] for r in rows],
            [[p["_gid"] if "_gid" in p else p["id"] for p in r["passages"]]
             for r in rows])


def _assert_same_eval(jmet, tmet, jpred, tpred):
    for key in ("exact_match", "f1", "retrieval_recall", "BLEU-1"):
        assert tmet[key] == jmet[key], key
    np.testing.assert_allclose(tmet["eval_loss"], jmet["eval_loss"],
                               rtol=1e-4)
    assert tpred == jpred


def test_jax_checkpoint_evaluates_in_the_port(mesh1, tmp_path):
    """A checkpoint the JAX trainer's ``save_checkpoint`` wrote (tiny
    geometry, a non-zero LoRA adapter, grown tokenizer vocabs) evaluates
    through ``python -m jsa_rag_tpu_torch.evaluate``'s ``main`` on the CPU
    with the JAX package's metrics, retrieved passages and answers."""
    from jsa_rag_tpu.model_io import load_or_initialize_model
    from jsa_rag_tpu.train.checkpoint import save_checkpoint

    passages = [{"id": str(i), "title": f"e{i}",
                 "text": f"e{i} has value v{i}"} for i in range(24)]
    (tmp_path / "passages.jsonl").write_text(
        "".join(json.dumps(p) + "\n" for p in passages))
    (tmp_path / "dev.jsonl").write_text("".join(
        json.dumps({"question": f"value of e{i}", "answers": [f"v{i}"]})
        + "\n" for i in range(5)))
    argv = ["--model_size", "tiny", "--precision", "fp32", "--task", "qa",
            "--n_context", "2", "--text_maxlength", "96",
            "--target_maxlength", "8", "--generation_max_length", "4",
            "--per_gpu_batch_size", "3", "--max_vocab", "600",
            "--index_dtype", "float32", "--lora_rank", "4",
            "--passages", str(tmp_path / "passages.jsonl"),
            "--eval_data", str(tmp_path / "dev.jsonl"),
            "--checkpoint_dir", str(tmp_path / "out"),
            "--write_results", "true"]
    jopt = jconfig.Options.from_args(argv + ["--name", "jax"])
    store = JStore(passages=load_passages_jsonl(str(tmp_path /
                                                    "passages.jsonl")))
    model, params, _ = load_or_initialize_model(jopt, store)
    rng = np.random.default_rng(0)
    params["lora"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), params["lora"])
    for p in passages:  # a vocabulary to restore
        model.retriever_tokenizer.tokenize(f"{p['title']} {p['text']}")
    save_checkpoint(str(tmp_path / "ckpt"), "run", 7, params, options=jopt,
                    tokenizer=model.generator_tokenizer,
                    retriever_tokenizer=model.retriever_tokenizer)
    index = JaxIndex(mesh1, len(store), model.retriever.cfg.bert.hidden,
                     dtype=jnp.float32)
    model.build_index(index, params)
    jmet = jevaluate(model, index, params, jopt,
                     str(tmp_path / "dev.jsonl"))

    results = tmain(argv + ["--name", "torch", "--device", "cpu",
                            "--model_path", str(tmp_path / "ckpt" / "run")])
    tmet = results["dev.jsonl"]
    _assert_same_eval(
        jmet, tmet,
        _predictions(tmp_path / "out" / "jax" / "dev.jsonl.jsonl"),
        _predictions(tmp_path / "out" / "torch" / "dev.jsonl.jsonl"))


def test_hard_copy_demo_evaluates_like_jax(mesh1, tmp_path):
    """The committed hard-copy artifacts (``docs/demo/artifacts``) over the
    first 16 dev questions of ``scripts/make_copy_task_data.py --hard``
    (the demo's data, seed 0): both packages retrieve the same passages
    from an f32 flat index (the port's through its ``pallas2`` method, kernel
    B3's plain version here), decode the same answers and report the same
    EM / F1 / recall."""
    from scripts.pretrain_copy_generator import load_generator
    from scripts.pretrain_hard_encoder import load_artifact
    from jsa_rag_tpu.config import Options as JOpt
    from jsa_rag_tpu.train.rag_model import RAGModel as JRAG
    from jsa_rag_tpu_torch.convert import load_demo_artifacts
    from jsa_rag_tpu_torch.ops import mips_topt
    from jsa_rag_tpu_torch.train.rag_model import RAGModel as TRAG

    data = tmp_path / "hardcopy"
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "scripts", "make_copy_task_data.py"),
                    "--out", str(data), "--hard", "--n_topics", "4000",
                    "--n_train_topics", "3000", "--n_eval", "200",
                    "--train_per_topic", "4"], check=True,
                   capture_output=True, timeout=120)
    with open(data / "dev.jsonl") as f:
        (tmp_path / "dev16.jsonl").write_text("".join(f.readlines()[:16]))
    enc = os.path.join(ARTIFACTS, "hard_encoder.pkl")
    gen = os.path.join(ARTIFACTS, "hard_generator.pkl")
    kw = dict(task="qa", gold_score_mode="rag", gen_method="fast_deocde1",
              qa_prompt_format="{question}", n_context=4, text_maxlength=96,
              target_maxlength=8, generation_max_length=4,
              per_gpu_batch_size=16, per_gpu_embedder_batch_size=256,
              use_lora=False, precision="fp32",
              checkpoint_dir=str(tmp_path / "out"), write_results=True)
    passages = load_passages_jsonl(str(data / "passages.jsonl"))

    ret, rp, tok = load_artifact(enc)
    lmc, gp, _ = load_generator(gen)
    jopt = JOpt(name="jax", **kw)
    jm = JRAG(jopt, ret, lmc, tok, tok, JStore(passages=passages))
    jparams = {"retriever": rp, "generator": gp}
    jidx = JaxIndex(mesh1, len(passages), 256, dtype=jnp.float32)
    jm.build_index(jidx, jparams)
    jmet = jevaluate(jm, jidx, jparams, jopt, str(tmp_path / "dev16.jsonl"))

    tret, tcfg, tgp, ttok = load_demo_artifacts(enc, gen, device="cpu")
    assert tcfg.dtype == torch.float32 and tret.cfg.tied
    topt = tconfig.Options(name="torch", device="cpu", **kw)
    tm = TRAG(topt, tret, tcfg, ttok, ttok, TStore(passages=passages))
    tparams = {"retriever": tret, "generator": tgp}
    tidx = TorchIndex(len(passages), 256, "float32", device="cpu",
                      method="pallas2")
    tm.build_index(tidx, tparams)
    calls = []
    real = mips_topt.scan_topt_dense_plain
    mips_topt.scan_topt_dense_plain = lambda *a: calls.append(1) or real(*a)
    try:
        tmet = tevaluate(tm, tidx, tparams, topt,
                         str(tmp_path / "dev16.jsonl"))
    finally:
        mips_topt.scan_topt_dense_plain = real
    assert calls  # the search went through B3's plain version
    jpred = _predictions(tmp_path / "out" / "jax" / "dev16.jsonl.jsonl")
    tpred = _predictions(tmp_path / "out" / "torch" / "dev16.jsonl.jsonl")
    _assert_same_eval(jmet, tmet, jpred, tpred)
    assert tmet["retrieval_recall"] == 1.0 and tmet["exact_match"] >= 0.9


def test_evaluate_cli_defaults_to_cuda(tmp_path):
    """Without ``--device`` the entry point asks for CUDA, and where there
    is none it raises instead of running on the CPU."""
    assert tconfig.Options.from_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "dev.jsonl").write_text(
        json.dumps({"question": "q", "answers": ["a"]}) + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        tmain(["--model_size", "tiny", "--eval_data",
               str(tmp_path / "dev.jsonl"),
               "--checkpoint_dir", str(tmp_path / "out")])
