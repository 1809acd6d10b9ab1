"""Port parity: the nine tasks of ``jsa_rag_tpu_torch.tasks`` against the JAX
package's on the same jsonl files, the multiple-choice evaluation end to
end, and one ``--task mlm`` training step of both loops.

Tolerances. Host-side task outputs (processed examples, batches, filter
results, metric values, permutations and their reduction) must be equal,
each call made after the same ``random.seed``. End to end both packages
compute in float32: the choice logits agree to 1e-5 absolute, the
predictions and the accuracies (averages of discrete choices) are equal,
the eval loss agrees to 1e-4 relative. The training step: the same
passages kept after the anti-cheat filter, and the losses to 1e-4
relative, the tolerance of ``tests/test_torch_train.py``."""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu.data.tokenizer import SimpleTokenizer as JTok
from jsa_rag_tpu.tasks import AVAILABLE_TASKS as JTASKS
from jsa_rag_tpu.tasks import get_task as jget_task
from jsa_rag_tpu.tasks.base import filter_results_by_id as jfilter
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer as TTok
from jsa_rag_tpu_torch.tasks import AVAILABLE_TASKS as TTASKS
from jsa_rag_tpu_torch.tasks import get_task as tget_task
from jsa_rag_tpu_torch.tasks.base import filter_results_by_id as tfilter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(min_words_per_lm_instance=4, multiple_choice_num_options=4,
            multiple_choice_train_permutations="all",
            multiple_choice_eval_permutations="cyclic",
            text_maxlength=32)
WORDS = [f"w{i}" for i in range(40)]


def _text(rng, n):
    return " ".join(rng.choice(WORDS, size=n).tolist())


def _examples(name, rng):
    """Six examples in the task's schema, some that its ``process`` drops."""
    if name == "base":
        return [{"query": _text(rng, 5), "target": _text(rng, 2)}
                for _ in range(6)]
    if name in ("mlm", "lm"):
        return [{"id": str(i), "title": f"t{i}",
                 "text": _text(rng, 3 if i == 2 else 12 + 3 * i)}
                for i in range(6)]
    if name == "section":
        return [{"id": str(i), "title": f"t{i}",
                 "section": "" if i == 1 else f"s{i}",
                 "text": _text(rng, 2 if i == 3 else 10)} for i in range(6)]
    if name == "multiple_choice":
        out = []
        for i in range(6):
            opts = dict(zip("ABCD", (_text(rng, 2) + f" o{i}{j}"
                                     for j in range(4))))
            out.append({"question": _text(rng, 6), "options": opts,
                        "answer": "ABCD"[i % 4]})
        return out
    if name == "kilt":
        return [{"input": _text(rng, 5), "filename":
                 "fever-dev.jsonl" if i == 4 else "nq-dev.jsonl",
                 "output": [{"answer": "SUPPORTS" if i == 4 else
                             _text(rng, 2)}, {"answer": " "},
                            {"provenance": []}] if i != 1 else
                 [{"provenance": []}]} for i in range(6)]
    if name == "fever":
        return [{"claim": _text(rng, 6), **({"label": lab} if lab else {})}
                for lab in ("SUPPORTS", "REFUTES", "NOT ENOUGH INFO", None,
                            "SUPPORTS", "REFUTES")]
    # qa, vanilla_qa
    return [{"question": _text(rng, 5), **({"target": "x y"} if i == 0 else
                                           {"answers": [_text(rng, 2),
                                                        _text(rng, 1)]})}
            for i in range(6)]


def _pair(name):
    jopt = jconfig.Options(task=name, **OPTS)
    topt = tconfig.Options(task=name, device="cpu", **OPTS)
    return (jopt, jget_task(jopt, JTok(max_vocab=600)),
            topt, tget_task(topt, TTok(max_vocab=600)))


def _seeded(seed, fn):
    random.seed(seed)
    return fn()


def test_registry_matches_jax():
    assert list(TTASKS) == list(JTASKS)
    assert len(TTASKS) == 9


@pytest.mark.parametrize("name", list(JTASKS))
def test_task_matches_jax(tmp_path, name):
    """``process``, ``data_iterator`` + ``batch_iterator`` (train and eval
    permutations for multiple choice), ``evaluation`` and, where the task
    has one, ``filter`` give the JAX task's outputs."""
    path = tmp_path / f"{name}.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in
                            _examples(name, np.random.default_rng(1))))
    jopt, jt, topt, tt = _pair(name)
    assert type(tt).metrics == type(jt).metrics
    assert callable(getattr(tt, "filter", None)) == \
        callable(getattr(jt, "filter", None))
    for is_eval in (False, True):
        def run(task, opt):
            it = task.data_iterator(str(path), 0, 1, opt=opt,
                                    is_eval=is_eval)
            ex = [e for e in map(task.process, it) if e is not None]
            return ex, [dict(b) for b in task.batch_iterator(iter(ex), 4)]
        jex, jb = _seeded(3, lambda: run(jt, jopt))
        tex, tb = _seeded(3, lambda: run(tt, topt))
        assert tex == jex and tb == jb
        assert 0 < len(tex)
    for pred, gold in [("w1 w2", ["w1 w2"]), ("w3", ["w4 w3", "x"]),
                       ("", ["w5"]), ("true", ["True."])]:
        assert tt.evaluation(pred, gold) == jt.evaluation(pred, gold)
    if callable(getattr(jt, "filter", None)):
        meta = [{"id": "1"}, {"id": "9"}, {"id": "2"}]
        ps = [[{"id": str(i)} for i in r] for r in
              ([1, 2, 3, 4], [5, 6, 7, 8], [2, 2, 2, 3])]
        ss = [[4.0, 3.0, 2.0, 1.0]] * 3
        for k in (2, 3):
            assert tt.filter(meta, ps, ss, k) == jt.filter(meta, ps, ss, k)
        assert tt.filter(None, ps, ss, 2) == jt.filter(None, ps, ss, 2)
    opt_row = tconfig.Options(task=name, device="cpu")
    assert tget_task(opt_row, None) is not None


def test_filter_results_by_id_matches_jax():
    """tests/test_utils_tasks.py::test_filter_results_by_id, and a row
    whose filter must re-append violating passages to fill ``topk``."""
    passages = [[{"id": "a"}, {"id": "b"}, {"id": "c"}],
                [{"id": "b"}, {"id": "b"}, {"id": "c"}]]
    scores = [[3, 2, 1], [9, 8, 7]]
    meta = [{"id": "b"}, {"id": "b"}]
    got = tfilter(meta, passages, scores, 2)
    assert got == jfilter(meta, passages, scores, 2)
    assert [p["id"] for p in got[0][0]] == ["a", "c"]
    assert [p["id"] for p in got[0][1]] == ["c", "b"]
    assert list(got[1][1]) == [7, 9]


@pytest.mark.parametrize("kind", ["single", "cyclic", "all"])
def test_mc_permutations_and_reduction_match_jax(kind):
    """The permutations (tests/test_utils_tasks.py::
    test_mc_permutations_and_reduce) and, on choice logits made up for
    them, ``evaluation_postprocessing``: the marginalised probabilities,
    predictions and ``debiased_accuracy``."""
    _, jt, _, tt = _pair("multiple_choice")
    ex = {"question": "q", "options": {"A": "x", "B": "y", "C": "z",
                                       "D": "w"}, "answer": "C"}
    jp, tp = jt.get_permutations(ex, kind), tt.get_permutations(ex, kind)
    assert tp == jp
    assert len(tp) == {"single": 1, "cyclic": 4, "all": 24}[kind]
    assert sum(p["is_original"] for p in tp) == 1
    for p in tp:
        assert p["options"][p["answer"]] == "z"
    rng = np.random.default_rng(2)
    rows = [{"query": "q", "generation": "A", "answers": [p["answer"]],
             "choice_logits": dict(zip("ABCD", rng.standard_normal(4)
                                       .tolist())), "metadata": p}
            for p in tp]
    metrics = {"accuracy": [1.0, 0.0]}
    jm, jd = jt.evaluation_postprocessing(dict(metrics), json.loads(
        json.dumps(rows)))
    tm, td = tt.evaluation_postprocessing(dict(metrics), json.loads(
        json.dumps(rows)))
    assert tm == jm and td == jd
    assert len(td) == 1 and set(td[0]["choice_probs"]) == set("ABCD")


@pytest.mark.parametrize("density,span", [(0.2, 3.0), (0.15, 1.0),
                                          (0.5, 2.0)])
def test_mlm_noise_spans_match_jax(density, span):
    """``apply_mlm_noise`` after the same ``random.seed``: the same inputs
    and sentinel targets (tests/test_utils_tasks.py::test_mlm_noise_spans);
    the spans put back together give the text."""
    _, jt, _, tt = _pair("mlm")
    text = " ".join(f"w{i}" for i in range(50))
    want = _seeded(7, lambda: jt.apply_mlm_noise(None, text, density, span,
                                                 512))
    got = _seeded(7, lambda: tt.apply_mlm_noise(None, text, density, span,
                                                512))
    assert got == want
    inp, out = got
    assert "<extra_id_0>" in inp and "<extra_id_0>" in out
    spans_in = inp.split("<extra_id_")
    spans_out = out.split("<extra_id_")
    rebuilt = []
    for a, b in zip(spans_in, spans_out[1:]):
        rebuilt += a.split(">", 1)[-1].split() + b.split(">", 1)[-1].split()
    assert rebuilt == text.split()


# ------------------------------------------------ multiple-choice evaluate
def test_multiple_choice_evaluate_matches_jax(tmp_path):
    """``python -m jsa_rag_tpu_torch.evaluate``'s ``main`` with ``--task
    multiple_choice --multiple_choice_eval_permutations cyclic`` on a
    JAX-written checkpoint against the JAX package's ``evaluate``
    (tests/test_evaluation.py::test_multiple_choice_eval): choice logits
    within 1e-5, the same predictions, accuracy and debiased accuracy."""
    from jsa_rag_tpu.data.passages import PassageStore as JStore
    from jsa_rag_tpu.evaluation import evaluate as jevaluate
    from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
    from jsa_rag_tpu.model_io import load_or_initialize_model
    from jsa_rag_tpu.parallel.mesh import make_mesh
    from jsa_rag_tpu.train.checkpoint import save_checkpoint
    from jsa_rag_tpu_torch.evaluate import main as tmain

    passages = [{"id": str(i), "title": f"e{i}",
                 "text": f"e{i} has value v{i}"} for i in range(24)]
    (tmp_path / "passages.jsonl").write_text(
        "".join(json.dumps(p) + "\n" for p in passages))
    rng = np.random.default_rng(4)
    with open(tmp_path / "mc.jsonl", "w") as f:
        for i in range(5):
            vals = [f"v{j}" for j in rng.choice(24, 4, replace=False)]
            f.write(json.dumps({"question": f"value of e{i}",
                                "options": dict(zip("ABCD", vals)),
                                "answer": "ABCD"[i % 4]}) + "\n")
    argv = ["--model_size", "tiny", "--precision", "fp32",
            "--task", "multiple_choice",
            "--multiple_choice_eval_permutations", "cyclic",
            "--n_context", "2", "--text_maxlength", "96",
            "--target_maxlength", "8", "--per_gpu_batch_size", "3",
            "--max_vocab", "600", "--index_dtype", "float32",
            "--lora_rank", "4", "--passages", str(tmp_path / "passages.jsonl"),
            "--eval_data", str(tmp_path / "mc.jsonl"),
            "--checkpoint_dir", str(tmp_path / "out"),
            "--write_results", "true"]
    jopt = jconfig.Options.from_args(argv + ["--name", "jax"])
    store = JStore(passages=passages)
    model, params, _ = load_or_initialize_model(jopt, store)
    params["lora"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), params["lora"])
    save_checkpoint(str(tmp_path / "ckpt"), "run", 3, params, options=jopt,
                    tokenizer=model.generator_tokenizer,
                    retriever_tokenizer=model.retriever_tokenizer)
    index = JaxIndex(make_mesh(n_data=1, n_index=1,
                               devices=jax.devices()[:1]),
                     len(store), model.retriever.cfg.bert.hidden,
                     dtype=jnp.float32)
    model.build_index(index, params)
    jmet = jevaluate(model, index, params, jopt, str(tmp_path / "mc.jsonl"))
    tmet = tmain(argv + ["--name", "torch", "--device", "cpu",
                         "--model_path", str(tmp_path / "ckpt" / "run")]
                 )["mc.jsonl"]
    assert set(tmet) == set(jmet) >= {"accuracy", "debiased_accuracy",
                                      "eval_loss"}
    for k in jmet:
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-4, err_msg=k)
        if k != "eval_loss":
            assert tmet[k] == jmet[k], k

    def rows(name):
        with open(tmp_path / "out" / name / "mc.jsonl.jsonl") as f:
            return [json.loads(line) for line in f]
    jrows, trows = rows("jax"), rows("torch")
    assert len(trows) == len(jrows) == 5
    for a, b in zip(trows, jrows):
        assert a["generation"] == b["generation"]
        assert a["choice_probs"].keys() == b["choice_probs"].keys()
        assert [p["generation"] for p in a["permutations"]] == \
            [p["generation"] for p in b["permutations"]]
        for pa, pb in zip(a["permutations"], b["permutations"]):
            assert pa["choice_logits"].keys() == pb["choice_logits"].keys()
            np.testing.assert_allclose(
                [pa["choice_logits"][c] for c in "ABCD"],
                [pb["choice_logits"][c] for c in "ABCD"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            [a["choice_probs"][c] for c in "ABCD"],
            [b["choice_probs"][c] for c in "ABCD"], rtol=0, atol=1e-5)


# ------------------------------------------------------- mlm training step
@pytest.mark.parametrize("mode", ["rag", "jsa"])
def test_mlm_training_step_matches_jax(tmp_path, monkeypatch, mode):
    """One training step of each package's loop with ``--task mlm`` on
    passages written with their ids as the training file, from the same
    init and index: retrieval over-fetches 8 and ``filter_results_by_id``
    drops each example's own passage; both keep the same passages, and the
    step's losses agree. jsa (its posterior and prior searches each
    filtered) at batch size 1, the port replaying the JAX run's MIS draws
    as in ``tests/test_torch_train.py``."""
    import subprocess
    import sys

    from jsa_rag_tpu import model_io as jmodel_io
    from jsa_rag_tpu.data.passages import PassageStore as JStore
    from jsa_rag_tpu.index import build_index_for as jbuild_index_for
    from jsa_rag_tpu.parallel.mesh import make_mesh
    from jsa_rag_tpu.train import loop as jloop
    from jsa_rag_tpu.train import optim as joptim
    from jsa_rag_tpu.train import step as jstep
    from jsa_rag_tpu_torch import convert
    from jsa_rag_tpu_torch import model_io as tmodel_io
    from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
    from jsa_rag_tpu_torch.index import load_index
    from jsa_rag_tpu_torch.train import loop as tloop
    from jsa_rag_tpu_torch.train import optim as toptim

    # 12 passages: each search's 3 + 8 fetched rows hold the example's own
    # passage or miss one other, so the filter has something to remove
    out = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_synthetic_data.py"),
                    "--out", str(out), "--n_passages", "12", "--n_train",
                    "4", "--n_dev", "2"], check=True, capture_output=True)
    passages = str(out / "passages.jsonl")
    with open(passages) as f:
        rows = [json.loads(line) for line in f][:4]
    train = tmp_path / "mlm.jsonl"
    train.write_text("".join(json.dumps(r) + "\n" for r in rows))
    batch = 2 if mode == "rag" else 1
    kw = dict(name="run", checkpoint_dir=str(tmp_path / "ck"), task="mlm",
              gold_score_mode=mode, mis_step=8, temperature_jsa=0.1,
              train_data=[str(train)],
              passages=[passages], model_size="tiny", precision="fp32",
              dropout=0.0, per_gpu_batch_size=batch, n_context=3, lr=1e-3,
              lr_retriever=1e-3, warmup_steps=1, total_steps=1,
              text_maxlength=32, target_maxlength=16, index_dtype="float32",
              log_freq=1, log_detail_num=1, save_freq=1000, eval_freq=1000,
              save_build_retriever_step=0, max_vocab=600, seed=0)
    jopt = jconfig.Options(**kw)
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jstore = JStore.from_jsonl(jopt.passages)
    jmodel, jparams, _ = jmodel_io.load_or_initialize_model(jopt, jstore)
    init = jax.tree_util.tree_map(np.array, jparams)
    jindex = jbuild_index_for(jopt, len(jstore),
                              jmodel.retriever.cfg.bert.hidden, mesh)
    jmodel.build_index(jindex, jparams)
    path = str(tmp_path / "index")
    jindex.save(path, n_files=1)
    # the passages each search keeps, and whether the filter removed one
    kept = {"jax": [], "torch": []}

    def spy(key, real):
        def wrapper(batch_metadata, passages, scores, topk, **k):
            res = real(batch_metadata, passages, scores, topk, **k)
            kept[key].append(([m["id"] for m in batch_metadata],
                              [[p["id"] for p in row[:topk + 8]]
                               for row in passages],
                              [[p["id"] for p in row] for row in res[0]]))
            return res
        return wrapper
    from jsa_rag_tpu.tasks import mlm as jmlm
    from jsa_rag_tpu_torch.tasks import mlm as tmlm
    monkeypatch.setattr(jmlm, "filter_results_by_id",
                        spy("jax", jmlm.filter_results_by_id))
    monkeypatch.setattr(tmlm, "filter_results_by_id",
                        spy("torch", tmlm.filter_results_by_id))

    jopt.load_index_path = path
    jparams, specs = jstep.setup_params(jopt, jparams, mesh)
    jtx, _ = joptim.set_optim(jopt, jparams)
    state = jstep.init_opt_state(jtx, jparams, specs, mesh)
    random.seed(0)
    jparams, _, jsteps = jloop.train(jmodel, jindex, jparams, jtx, state,
                                     jopt, mesh=mesh)
    assert jsteps == 1

    if mode == "jsa":
        from jsa_rag_tpu_torch.train import modes as tmodes

        with open(tmp_path / "ck" / "run" / "training_info_step1.json") as f:
            info = json.load(f)
        draws = (np.asarray(info["debug/proposal_ids"], np.int64),
                 np.asarray(info["debug/uniform_draws"], np.float32))
        monkeypatch.setattr(tmodes, "draw_mis", lambda gen, post, n: (
            torch.from_numpy(draws[0][:, None]),
            torch.from_numpy(draws[1][:, None])))
    topt = tconfig.Options(device="cpu", **dict(kw, name="torch"))
    tmodel, _, _ = tmodel_io.load_or_initialize_model(
        topt, TStore.from_jsonl(topt.passages))
    tparams = convert.params_from_numpy(init, tmodel.retriever.cfg)
    for name in ("retriever_tokenizer", "generator_tokenizer"):
        jt, tt = getattr(jmodel, name), getattr(tmodel, name)
        tt.vocab, tt.inv = dict(jt.vocab), dict(jt.inv)
    topt.load_index_path = path
    tindex = load_index(path, device="cpu")
    random.seed(0)
    assert tloop.train(tmodel, tindex, tparams,
                       toptim.set_optim(topt, tparams), topt) == 1
    assert kept["torch"] == kept["jax"] and kept["torch"]
    # each row keeps its first three fetched passages that are not its
    # example's own, the own ones re-appended only to fill three; and the
    # filter removed one somewhere
    removed = 0
    for ids, fetched, got in kept["torch"]:
        assert set(ids) <= {r["id"] for r in rows}
        for own, f_row, g_row in zip(ids, fetched, got):
            others = [i for i in f_row if i != own]
            assert g_row == (others + [i for i in f_row if i == own])[:3]
            removed += own in f_row
    assert removed

    def metrics(name):
        with open(tmp_path / "ck" / name / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]
    jm, tm = metrics("run"), metrics("torch")
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == [1]
    for k in ("loss/train_loss", "loss/generator_loss"):
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=1e-4, err_msg=k)
