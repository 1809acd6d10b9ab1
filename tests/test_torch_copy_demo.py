"""The copy-task demos and the HF interop drive of the port
(``jsa_rag_tpu_torch/demo/{copy_task,e2e_copy,jsa_mechanism,hf_interop}``)
against the JAX scripts they port, on the CPU, at a small copy set
(``scripts/make_copy_task_data.py`` at 60 topics) and a generator
copy-pretrained for 3 steps by the train entry.

With the JAX initialisation carried over by ``convert.py``: the mechanism
probe's towers have the JAX script's trees and sharing
(``docs/demo/jsa_mechanism_demo.py:77-85``), its ``prior_gold_recall``
equals the JAX script's on the same weights and index, and the e2e
demo's evaluation before training equals the JAX ``evaluate`` (EM, F1,
retrieval recall; ``docs/demo/e2e_copy_task.py``). The train entry's
concat checkpoint loads in both packages. Each demo's ``main`` runs 3
steps; the HF writer's directories load in ``transformers`` with the same
tensors and forward as the port's towers; the drive's steps run with rc 0;
and every new entry point asks for CUDA by default."""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.config import Options as JOptions
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.data.passages import load_passages_jsonl as jload_passages
from jsa_rag_tpu.evaluation import evaluate as jevaluate
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JIndex
from jsa_rag_tpu.models.bert import BertConfig as JBert
from jsa_rag_tpu.models.lm import LMConfig as JLM
from jsa_rag_tpu.models.retriever import DualEncoderRetriever as JRetriever
from jsa_rag_tpu.models.retriever import RetrieverConfig as JRetrieverConfig
from jsa_rag_tpu.parallel import default_mesh
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.train import checkpoint as jckpt
from jsa_rag_tpu.train import modes as jmodes
from jsa_rag_tpu.train.loop import train as jtrain
from jsa_rag_tpu.train.optim import set_optim as jset_optim
from jsa_rag_tpu.train.rag_model import RAGModel as JRAGModel
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch.analysis import (int8r_gap_probe, mips_tune,
                                        refine_bench)
from jsa_rag_tpu_torch.demo import (copy_task, e2e_copy, hf_interop,
                                    jsa_mechanism)
from jsa_rag_tpu_torch.models import RetrieverConfig, hf_import
from jsa_rag_tpu_torch.models.lm import lm_logits
from jsa_rag_tpu_torch.train import checkpoint as tckpt
from jsa_rag_tpu_torch.train import modes as tmodes
from jsa_rag_tpu_torch.train.loop import train as ttrain
from jsa_rag_tpu_torch.train.optim import set_optim as tset_optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
# jsa steps and batch of the replay test: 4 steps of 2 rows by default
# (the script's batch of 16 takes ~10 GiB and ~70 s here); the environment
# may ask for more, e.g. a few hundred steps or the batch of 16
MECH_REPLAY_STEPS = int(os.environ.get("MECH_REPLAY_STEPS", "4"))
MECH_REPLAY_BATCH = int(os.environ.get("MECH_REPLAY_BATCH", "2"))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("copy") / "data")
    return copy_task.make_data(out, n_topics=60, n_train_topics=40,
                               n_eval=10)


@pytest.fixture(scope="module")
def generator(data, tmp_path_factory):
    """The copy generator after 3 steps of the train entry; -> (main's
    result, the run directory)."""
    ck = str(tmp_path_factory.mktemp("ck"))
    r = copy_task.main(["--data", data, "--checkpoint_dir", ck, "--steps",
                        "3", *CPU])
    return r, r["checkpoint"]


def _jax_bow(vocab: int, tied: bool):
    cfg = JBert(vocab_size=vocab, hidden=256, layers=0, heads=4,
                intermediate=64, max_positions=96, pooling="mean_norm",
                dtype=jnp.float32)
    return JRetriever(JRetrieverConfig(bert=cfg, tied=tied)), cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_copy_generator_checkpoint_loads_in_both_packages(generator):
    """The train entry's concat checkpoint: the port's and the JAX
    ``load_checkpoint`` read the same step and generator leaves, and the
    same tokenizer; ``copy_task.main`` reports its metrics."""
    r, run = generator
    assert r["steps"] == 3 and r["losses"]
    assert all(np.isfinite(v) for _, v in r["losses"])
    assert 0.0 <= r["em_with_gold_unseen"] <= 1.0
    t, j = tckpt.load_checkpoint(run), jckpt.load_checkpoint(run)
    assert t["step"] == j["step"] == 3
    tl = jax.tree_util.tree_leaves(t["params"]["generator"])
    jl = jax.tree_util.tree_leaves(_np_tree(j["params"]["generator"]))
    assert len(tl) == len(jl) > 0
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(np.asarray(a), b)
    ttok, _ = tckpt.load_tokenizers_from_checkpoint(run)
    jtok, _ = jckpt.load_tokenizers_from_checkpoint(run)
    assert ttok.vocab == jtok.vocab and ttok.vocab_size == 50000
    cfg, gen, tok = copy_task.load_generator_checkpoint(run, "cpu")
    assert (cfg.hidden, cfg.layers, cfg.heads, cfg.kv_heads,
            cfg.intermediate) == (256, 4, 8, 4, 512)
    assert tok.vocab == ttok.vocab


def _jax_mechanism(vocab: int):
    """The JAX script's towers (``:77-85``)."""
    ret, _ = _jax_bow(vocab, tied=False)
    towers = ret.init(jax.random.PRNGKey(0))
    prior = {"query": ret.init(jax.random.PRNGKey(7))["query"],
             "passage": towers["passage"]}
    post_query = jax.tree_util.tree_map(lambda x: x, towers["passage"])
    return ret, towers, prior, post_query


def _port_mechanism(vocab: int):
    """The port's towers assembled from the JAX init."""
    _, towers, prior, _ = _jax_mechanism(vocab)
    cfg = RetrieverConfig(bert=copy_task.bow_config(vocab), tied=False)
    a = convert.retriever_from_numpy(_np_tree(towers), cfg)
    b = convert.retriever_from_numpy(
        _np_tree({"query": prior["query"], "passage": towers["passage"]}),
        cfg)
    return a, b, copy_task.assemble_mechanism(a, b)


def test_mechanism_towers_have_the_scripts_trees():
    """Structure and sharing: the prior pairs seed B's query tower with
    seed A's passage tower (the same module, not a copy); the posterior
    holds only a query tower, a copy of A's passage tower; the trees equal
    the JAX script's leaf for leaf; the drawn towers share the same way."""
    vocab = 64
    _, _, jprior, jpost = _jax_mechanism(vocab)
    a, b, (prior, post) = _port_mechanism(vocab)
    assert prior.passage is a.passage and prior.query is b.query
    assert post.tower_names() == ["query"] and post.query is not a.passage
    got = convert.params_to_numpy({"retriever": prior,
                                   "post_retriever": post})
    want = {"retriever": _np_tree(jprior),
            "post_retriever": {"query": _np_tree(jpost)}}
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(x, y)
    _, jcfg = _jax_bow(vocab, tied=False)
    assert {k: v for k, v in dataclasses.asdict(
        copy_task.bow_config(vocab)).items() if k in dataclasses.asdict(
            jcfg) and k != "dtype"} == {
        k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
    prior, post = copy_task.mechanism_towers(vocab, 0, "cpu")
    word = [t.embed.word for t in (post.query, prior.passage, prior.query)]
    assert torch.equal(word[0], word[1]) and word[0] is not word[1]
    assert not torch.equal(word[2], word[1])


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "docs", "demo", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_model(opt, ret, run, data, mesh=None):
    """A JAX ``RAGModel`` and an f32 index over the copy passages (on
    ``mesh``, else every device), with the checkpoint's generator, as the
    JAX scripts build them."""
    state = jckpt.load_checkpoint(run)
    tok, _ = jckpt.load_tokenizers_from_checkpoint(run)
    lmc = JLM(vocab_size=tok.vocab_size, hidden=256, layers=4, heads=8,
              kv_heads=4, intermediate=512, dtype=jnp.float32)
    store = JStore(passages=jload_passages(os.path.join(data,
                                                        "passages.jsonl")))
    model = JRAGModel(opt, ret, lmc, tok, tok, store)
    index = JIndex(mesh or default_mesh(), len(store), 256,
                   dtype=jnp.float32)
    return model, index, state["params"]["generator"]


def test_prior_gold_recall_matches_jax(data, generator, tmp_path):
    """The same towers (the JAX init), generator and corpus: the port's
    ``prior_gold_recall`` over its index equals the JAX script's function
    over the JAX index."""
    run = generator[1]
    vocab = tckpt.load_tokenizers_from_checkpoint(run)[0].vocab_size
    ret, _, jprior, jpost = _jax_mechanism(vocab)
    _, _, towers = _port_mechanism(vocab)
    model, index, params, _, questions, code2id = jsa_mechanism.setup(
        data, run, steps=3, seed=0, device="cpu",
        checkpoint_dir=str(tmp_path), towers=towers)
    got = jsa_mechanism.prior_gold_recall(model, index, params, questions,
                                          code2id)
    opt = jsa_mechanism.jsa_options(data, steps=3, seed=0, device="cpu",
                                    checkpoint_dir=str(tmp_path))
    jopt = JOptions(**{f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(JOptions)})
    jmodel, jindex, gen = _jax_model(jopt, ret, run, data)
    jparams = {"retriever": jprior, "post_retriever": {"query": jpost},
               "generator": gen}
    jmodel.build_index(jindex, jparams)
    want = _jax_script("jsa_mechanism_demo").prior_gold_recall(
        jmodel, jindex, jparams, questions, code2id)
    assert got == want
    assert 0.0 <= got <= 1.0


def _metric_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_mechanism_steps_match_jax_on_the_same_draws(data, generator,
                                                     tmp_path, monkeypatch):
    """The mechanism probe's jsa steps with the JAX script's options
    (``jsa_mechanism_demo.py:88-105``: decoupled and query-side training,
    mis_step 8 over the union of every MIS state, temperature_jsa 0.1;
    ``MECH_REPLAY_BATCH`` rows of its 16), its towers and the copy
    generator, logged every step: the
    JAX loop's MIS draws (every row's proposals and uniforms, captured at
    run time) replayed into the port's loop give the same accept rate,
    loss and generator loss at every step. Only the draws' random streams
    differ between the packages (threefry and Philox)."""
    steps = MECH_REPLAY_STEPS
    run = generator[1]
    vocab = tckpt.load_tokenizers_from_checkpoint(run)[0].vocab_size
    ret, _, jprior, jpost = _jax_mechanism(vocab)
    _, _, towers = _port_mechanism(vocab)
    model, index, params, opt, _, _ = jsa_mechanism.setup(
        data, run, steps=steps, seed=0, device="cpu",
        checkpoint_dir=str(tmp_path / "port"), towers=towers)
    opt.log_freq, opt.per_gpu_batch_size = 1, MECH_REPLAY_BATCH
    jopt = JOptions(**{f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(JOptions)})
    jopt.checkpoint_dir = str(tmp_path / "jax")
    # one device (the tests' CPU mesh has 8, each of which would hold the
    # whole step), as the port's one process
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jmodel, jindex, gen = _jax_model(jopt, ret, run, data, mesh)
    # the script's posterior tower holds the passage tower's arrays
    # themselves; the JAX train step donates its params, which needs
    # distinct buffers
    jparams = {"retriever": jprior, "post_retriever": {
        "query": jax.tree_util.tree_map(jnp.copy, jpost)}, "generator": gen}
    jmodel.build_index(jindex, jparams)
    draws = []
    chain = jmodes.mis_chain

    def spy(rng, post, prior, log_lm, **kw):
        out = chain(rng, post, prior, log_lm, **kw)
        jax.debug.callback(lambda p, u: draws.append(
            (np.array(p, np.int64), np.array(u, np.float32))),
            out[2]["proposals"], out[2]["uniforms"])
        return out

    monkeypatch.setattr(jmodes, "mis_chain", spy)
    tx, _ = jset_optim(jopt, jparams)
    jtrain(jmodel, jindex, jparams, tx, tx.init(jparams), jopt, mesh=mesh)
    assert len(draws) == steps
    assert draws[0][0].shape == (opt.mis_step, opt.per_gpu_batch_size)

    def replay(gen_, post, mis_step):
        p, u = draws.pop(0)
        assert p.shape == (mis_step, post.shape[0])
        return torch.from_numpy(p), torch.from_numpy(u)

    monkeypatch.setattr(tmodes, "draw_mis", replay)
    assert ttrain(model, index, params, tset_optim(opt, params),
                  opt) == steps
    assert not draws
    want = _metric_rows(os.path.join(jopt.checkpoint_dir, jopt.name,
                                     "metrics.jsonl"))
    got = _metric_rows(os.path.join(opt.checkpoint_dir, opt.name,
                                    "metrics.jsonl"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(
        range(1, steps + 1))
    for a, b in zip(got, want):
        for k in ("accept_rate", "loss/train_loss", "loss/generator_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    print("accept rates (step, port, jax):", [
        (a["step"], round(a["accept_rate"], 4), round(b["accept_rate"], 4))
        for a, b in zip(got, want)])


def test_e2e_zero_shot_matches_jax_evaluate(data, generator, tmp_path):
    """The tied bag-of-words retriever (the JAX init) and the copy
    generator: the port's evaluation before training (``e2e_copy.setup``,
    the index built, ``evaluate``) gives the JAX ``evaluate``'s exact
    match, F1 and retrieval recall."""
    from jsa_rag_tpu_torch.evaluation import evaluate

    run = generator[1]
    vocab = tckpt.load_tokenizers_from_checkpoint(run)[0].vocab_size
    ret, _ = _jax_bow(vocab, tied=True)
    jret_params = ret.init(jax.random.PRNGKey(0))
    cfg = RetrieverConfig(bert=copy_task.bow_config(vocab), tied=True)
    tret = convert.retriever_from_numpy(_np_tree(jret_params), cfg)
    model, index, params, opt = e2e_copy.setup(
        data, run, steps=3, seed=0, device="cpu",
        checkpoint_dir=str(tmp_path), retriever=tret)
    model.build_index(index, params)
    got = evaluate(model, index, params, opt, opt.eval_data[0])
    jopt = JOptions(**{f.name: getattr(opt, f.name)
                       for f in dataclasses.fields(JOptions)})
    jmodel, jindex, gen = _jax_model(jopt, ret, run, data)
    jparams = {"retriever": jret_params, "generator": gen}
    jmodel.build_index(jindex, jparams)
    want = jevaluate(jmodel, jindex, jparams, jopt, opt.eval_data[0])
    for key in ("exact_match", "f1", "retrieval_recall"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


def test_demo_mains_run_on_the_cpu(data, generator, tmp_path):
    """e2e_copy and jsa_mechanism end to end for 3 steps each: finite
    losses, the two metric lines, the accept rate in (0, 1]."""
    run = generator[1]
    common = ["--data", data, "--generator", run, "--checkpoint_dir",
              str(tmp_path), "--steps", "3", *CPU]
    out = tmp_path / "e2e.jsonl"
    joint = e2e_copy.main([*common, "--out", str(out)])
    assert joint["steps"] == 3 and joint["losses"]
    assert all(np.isfinite(v) for _, v in joint["losses"])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["phase"] for r in lines] == ["zero_shot", "after_joint_3"]
    assert all(set(r) == {"phase", "exact_match", "f1", "retrieval_recall"}
               for r in lines)
    mech = jsa_mechanism.main([*common, "--out",
                               str(tmp_path / "mech.jsonl")])
    assert mech["steps"] == 3 and mech["losses"] and mech["accept_rates"]
    assert all(0 < v <= 1 for _, v in mech["accept_rates"])
    assert all(np.isfinite(v) for _, v in mech["losses"])
    assert 0.0 <= mech["recall@4_before"] <= 1.0
    assert json.loads((tmp_path / "mech.jsonl").read_text()) == \
        json.loads(json.dumps(mech))


def test_hf_writer_loads_in_transformers(tmp_path):
    """The drive's BERT and GPT-2 directories load in ``BertModel`` and
    ``GPT2LMHeadModel`` with the file's tensors, and their forwards equal
    the port's towers (imported from the same files) within 1e-5."""
    transformers = pytest.importorskip("transformers")
    words = [f"w{i}" for i in range(40)] + ["what", "is", "the"]
    g = torch.Generator().manual_seed(0)
    bdir, gdir = str(tmp_path / "bert"), str(tmp_path / "gpt2")
    bcfg = hf_interop.write_bert(bdir, words, g)
    gcfg = hf_interop.write_gpt2(gdir, words, g)
    ids = torch.randint(5, bcfg["vocab_size"], (3, 11),
                        generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)

    hf = transformers.BertModel.from_pretrained(bdir).eval()
    sd = hf_import.read_state_dict(bdir)
    for k, v in hf.state_dict().items():
        if k in sd:
            assert torch.equal(v, sd[k]), k
    cfg, tree = hf_import.load_hf_retriever(bdir, "mean")
    tower = convert.retriever_from_numpy(
        {"shared": tree}, RetrieverConfig(bert=cfg, tied=True)).shared
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        got = tower.hidden(ids, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)

    hf = transformers.GPT2LMHeadModel.from_pretrained(gdir).eval()
    sd = hf_import.read_state_dict(gdir)
    for k, v in hf.state_dict().items():
        if k in sd:
            assert torch.equal(v, sd[k]), k
    gids = torch.randint(1, gcfg["vocab_size"], (2, 9),
                         generator=torch.Generator().manual_seed(2))
    lcfg, ltree = hf_import.load_hf_generator(gdir)
    lcfg = dataclasses.replace(lcfg, dtype=torch.float32)
    with torch.no_grad():
        want = hf(input_ids=gids).logits
        got = lm_logits(convert.lm_params_from_numpy(ltree), lcfg, gids,
                        torch.ones_like(gids))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_hf_drive_runs_on_the_cpu(tmp_path):
    """The drive's five steps (six subprocesses) at its sizes, 2 training
    steps: every rc 0, the transcript names each model's tokenizer class,
    the round trip keeps the saved index's 300 rows and passages, and its
    recall."""
    out = tmp_path / "transcript.md"
    r = hf_interop.main(["--work", str(tmp_path / "work"), "--out",
                         str(out), "--steps", "2", *CPU])
    assert [s["rc"] for s in r["steps"]] == [0] * 6
    text = out.read_text()
    for cls in r["tokenizers"].values():
        assert cls in text
    assert r["roundtrip"] == {"rows": 300, "rows_equal": True,
                              "passages_equal": True}
    assert abs(r["recall_roundtrip"] - r["recall_saved"]) <= 0.02


@pytest.mark.parametrize("fault", ["none", "rows", "passages"])
def test_roundtrip_check_sees_scrambled_rows_and_ids(tmp_path, fault):
    """``roundtrip_matches`` on a saved f32 index exported to Atlas's
    format and converted back: equal as written, and unequal where two rows
    or two passages of the round trip are swapped."""
    from jsa_rag_tpu_torch.index import atlas_io
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex

    n, d = 40, 16
    rows = np.random.default_rng(3).standard_normal((n, d)).astype(
        np.float32)
    idx = ShardedFlatIndex(n, d, "float32", device="cpu")
    idx.set_embeddings(0, rows)
    saved, atlas, rt = (str(tmp_path / x) for x in ("saved", "atlas", "rt"))
    idx.save(saved, n_files=2)
    passages = [{"id": str(i), "title": f"t{i}", "text": f"passage {i}"}
                for i in range(n)]
    ppath = str(tmp_path / "passages.jsonl")
    with open(ppath, "w") as f:
        f.writelines(json.dumps(p) + "\n" for p in passages)
    atlas_io.save_index_atlas_format(idx, passages, atlas,
                                     total_saved_shards=4)
    atlas_io.convert_atlas_index(atlas, rt)
    if fault == "rows":
        shard = os.path.join(rt, "embeddings.1.npy")
        e = np.load(shard)
        np.save(shard, e[[1, 0, *range(2, len(e))]])
    elif fault == "passages":
        with open(os.path.join(rt, "passages.jsonl")) as f:
            lines = f.readlines()
        lines[3], lines[7] = lines[7], lines[3]
        with open(os.path.join(rt, "passages.jsonl"), "w") as f:
            f.writelines(lines)
    got = hf_interop.roundtrip_matches(saved, ppath, rt)
    assert got == {"rows": n, "rows_equal": fault != "rows",
                   "passages_equal": fault != "passages"}


ENTRY_POINTS = [
    (refine_bench, []), (int8r_gap_probe, []), (mips_tune, []),
    (copy_task, ["--data", "d", "--checkpoint_dir", "c"]),
    (e2e_copy, ["--data", "d", "--generator", "g", "--checkpoint_dir", "c",
                "--out", "o"]),
    (jsa_mechanism, ["--data", "d", "--generator", "g", "--checkpoint_dir",
                     "c", "--out", "o"]),
    (hf_interop, ["--work", "w", "--out", "o"]),
]


@pytest.mark.parametrize("module,argv", ENTRY_POINTS,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m, _ in ENTRY_POINTS])
def test_entry_points_default_to_cuda(module, argv):
    """Without ``--device`` each new entry point asks for CUDA, and where
    there is none it raises before any work instead of running on the
    CPU."""
    assert module.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)

