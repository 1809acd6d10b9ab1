"""Port parity: the jsa training slice of ``jsa_rag_tpu_torch`` against the
JAX package on the CPU — LR schedules and the refresh scheduler, the
optimizer against optax, the jsa loss and its gradients, the training
batch, checkpoints both ways, and three steps of both training loops.

Inputs come from numpy seeds or from the JAX package's own init (its params
converted to the port). Dropout is 0 and the MIS draws are replayed: torch's
Philox and JAX's threefry give different random numbers.

Tolerances. LR values and scheduler decisions are equal. Token batches,
retrieved ids and union masks are equal. Checkpoint leaves are equal. The
jsa loss agrees to 1e-5 relative and each gradient leaf to 1e-4 relative
plus 5e-4 of the largest JAX gradient of its tower (or of its top-level
tree) absolute: float32 sums in another order through two encoders and the
generator, and leaves whose exact gradient is zero (attention key biases)
or nearly so come out as rounding noise of the tower's gradients, after
LayerNorm and the normalised pooling cancel most of them. The optimizer: the
same float32 update rules give the same first step bit for bit, then params
within 1e-6 relative and absolute: where a first moment nearly cancels, a
last-bit difference in the moments grows in Adam's normalised update (steps
of lr = 3e-2 here). The loops: per-step
losses to 1e-4 relative, final params to 1e-5 absolute (Adam normalises
each update, so a gradient that differs by float rounding moves its weight
by up to lr x its relative error)."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu import model_io as jmodel_io
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.index import build_index_for as jbuild_index_for
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.train import checkpoint as jckpt
from jsa_rag_tpu.train import loop as jloop
from jsa_rag_tpu.train import modes as jmodes
from jsa_rag_tpu.train import optim as joptim
from jsa_rag_tpu.train import step as jstep
from jsa_rag_tpu.utils import schedulers as jsched
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
from jsa_rag_tpu_torch.index import load_index
from jsa_rag_tpu_torch.models.retriever import make_posterior
from jsa_rag_tpu_torch.train import checkpoint as tckpt
from jsa_rag_tpu_torch.train import loop as tloop
from jsa_rag_tpu_torch.train import modes as tmodes
from jsa_rag_tpu_torch.train import optim as toptim
from jsa_rag_tpu_torch.train.__main__ import main as tmain
from jsa_rag_tpu_torch.utils import schedulers as tsched

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("kind", ["linear", "cosine", "fixed"])
def test_lr_schedule_values_exact(kind):
    for lr, warmup, total in ((2e-5, 1000, 20000), (1e-5, 2, 8),
                              (1e-4, 7, 50), (3e-4, 0, 10)):
        j = jsched.make_lr_schedule(kind, lr, warmup, total)
        t = tsched.make_lr_schedule(kind, lr, warmup, total)
        steps = list(range(total + 3)) + [total * 3]
        want = np.array([np.float32(j(s)) for s in steps])
        got = np.array([t(s).item() for s in steps], np.float32)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tsched.make_lr_schedule("step", 1e-4, 1, 10)


@pytest.mark.parametrize("spec,freeze,train_retriever", [
    ("0-40000:40000", -1, True), ("0-4:2", -1, True),
    ("0-10:3,10-30:7", 5, True), ("4", -1, True), ("-1", -1, True),
    ("0-10:2", -1, False)])
def test_refresh_scheduler_decisions(spec, freeze, train_retriever):
    j = jsched.IndexRefreshScheduler(spec, freeze, train_retriever)
    t = tsched.IndexRefreshScheduler(spec, freeze, train_retriever)
    assert [t.is_time_to_refresh(s) for s in range(45)] == \
        [j.is_time_to_refresh(s) for s in range(45)]


# ------------------------------------------------------------ optimizer
def _opt_tree(rng):
    """A params tree with every label: lm (query towers, LoRA), retr (the
    prior passage tower), frozen (the posterior passage tower, the
    LoRA-frozen generator base)."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "retriever": {"query": {"w": a(6, 4), "b": a(4)},
                      "passage": {"w": a(6, 4)}},
        "post_retriever": {"query": {"w": a(6, 4)},
                           "passage": {"w": a(6, 4)}},
        "generator": {"embed": a(5, 3), "layers": [{"q_w": a(3, 3)}]},
        "lora": {"layers": [{"q_w": {"A": a(3, 2), "B": a(2, 3)}}]},
    }


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("accumulation", [1, 2])
def test_optimizer_matches_optax(accumulation):
    """Three updates (six micro-steps under accumulation 2) of the port's
    AdamW against the JAX package's optax transform on the same gradients:
    clipping active (norms ~10 against clip 1), the prior passage tower
    with a zero gradient (decays), the posterior passage tower frozen with
    a gradient that counts in the norm, the generator base frozen."""
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    kw = dict(lr=3e-2, lr_retriever=1e-2, warmup_steps=2, total_steps=6,
              weight_decay=0.1, clip=1.0, accumulation_steps=accumulation,
              scheduler="cosine", use_lora=True)
    jopt, topt = jconfig.Options(**kw), tconfig.Options(device="cpu", **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tx, labels = joptim.set_optim(jopt, jparams)
    state = tx.init(jparams)
    tparams = jax.tree_util.tree_map(lambda x: torch.tensor(np.array(x)),
                                     tree)
    ttx = toptim.set_optim(topt, tparams)
    jlabels = {p: v.item() for p, v in _flat(labels).items()}
    assert ttx.labels == [jlabels[p] for p in ttx.paths]
    for _ in range(3 * accumulation):
        grads = {p: 10 * rng.standard_normal(v.shape).astype(np.float32)
                 for p, v in _flat(tree).items()}
        for p in grads:
            if p[:2] == ("retriever", "passage") or p[0] == "generator":
                grads[p] = np.zeros_like(grads[p])
        jgrads = _unflat(jparams, grads)
        updates, state = tx.update(jgrads, state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        ttx.step([None if (p[:2] == ("retriever", "passage")
                           or p[0] == "generator")
                  else torch.from_numpy(grads[p]) for p in ttx.paths])
        want = _flat(jparams)
        for p, leaf in zip(ttx.paths, ttx.leaves):
            np.testing.assert_allclose(leaf.detach().numpy(), want[p],
                                       rtol=1e-6, atol=1e-6, err_msg=str(p))
    flat0 = _flat(tree)
    for p, leaf in zip(ttx.paths, ttx.leaves):
        moved = not np.array_equal(leaf.detach().numpy(), flat0[p])
        frozen = p[0] == "generator" or p[:2] == ("post_retriever",
                                                  "passage")
        assert moved != frozen, p  # frozen bit-identical, the rest moved


def _unflat(like, flat, prefix=()):
    if isinstance(like, dict):
        return {k: _unflat(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflat(v, flat, prefix + (str(i),))
                for i, v in enumerate(like)]
    return jnp.asarray(flat[prefix])


@pytest.mark.parametrize("flags", [
    dict(), dict(decouple_encoder=True),
    dict(query_side_retriever_training=True),
    dict(separate_learning_rates=False), dict(train_retriever=False),
    dict(use_lora=False)])
def test_label_tree_matches_jax(flags):
    """Every leaf of a tiny jsa model gets the JAX label."""
    kw = dict(model_size="tiny", max_vocab=300, gold_score_mode="jsa",
              **flags)
    jopt = jconfig.Options(**kw)
    _, jparams, _ = jmodel_io.load_or_initialize_model(
        jopt, JStore.synthetic(8))
    jlabels = {p: v.item() for p, v in
               _flat(joptim._label_tree(jparams, jopt)).items()}
    topt = tconfig.Options(device="cpu", **kw)
    _, tparams, _ = tmodel_io.load_or_initialize_model(
        topt, TStore.synthetic(8))
    ttx = toptim.AdamW(topt, tparams)
    assert set(ttx.paths) == set(jlabels)
    assert dict(zip(ttx.paths, ttx.labels)) == jlabels


# ------------------------------------------------------- models and data
def _data(tmp_path, n_passages=48, n_train=8):
    import subprocess
    import sys

    out = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_synthetic_data.py"),
                    "--out", str(out), "--n_passages", str(n_passages),
                    "--n_train", str(n_train), "--n_dev", "2"],
                   check=True, capture_output=True)
    return str(out / "train.jsonl"), str(out / "passages.jsonl")


def _kw(tmp_path, index_dtype="int8r", n_train=8, **over):
    train, passages = _data(tmp_path, n_train=n_train)
    kw = dict(name="run", checkpoint_dir=str(tmp_path / "ck"), task="qa",
              qa_prompt_format="{question}", gold_score_mode="jsa",
              train_data=[train], passages=[passages], model_size="tiny",
              precision="fp32", dropout=0.0, per_gpu_batch_size=1,
              n_context=3, mis_step=8, temperature_gold=1.0,
              temperature_score=1.0, temperature_jsa=0.1, lr=1e-3,
              lr_retriever=1e-3, warmup_steps=1, total_steps=3,
              text_maxlength=32, target_maxlength=16, index_dtype=index_dtype,
              log_freq=1, log_detail_num=3, save_freq=1000, eval_freq=1000,
              save_build_retriever_step=0, max_vocab=600, seed=0)
    kw.update(over)
    return kw


def _pair(tmp_path, index_dtype="int8r", **over):
    """The JAX model (params, index built and saved) and the port's model
    on the JAX params, the saved index and the JAX tokenizers' vocab."""
    kw = _kw(tmp_path, index_dtype, **over)
    jopt = jconfig.Options(**kw)
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jstore = JStore.from_jsonl(jopt.passages)
    jmodel, jparams, _ = jmodel_io.load_or_initialize_model(jopt, jstore)
    jindex = jbuild_index_for(jopt, len(jstore),
                              jmodel.retriever.cfg.bert.hidden, mesh)
    jmodel.build_index(jindex, jparams)
    path = str(tmp_path / "index")
    jindex.save(path, n_files=2)
    topt = tconfig.Options(device="cpu", **kw)
    tmodel, _, _ = tmodel_io.load_or_initialize_model(
        topt, TStore.from_jsonl(topt.passages))
    init = jax.tree_util.tree_map(np.array, jparams)
    tparams = convert.params_from_numpy(init, tmodel.retriever.cfg)
    tindex = load_index(path, device="cpu", refine_r=topt.refine_r,
                        int8r_refine=topt.int8r_refine)
    return (jopt, mesh, jmodel, jparams, jindex, path,
            topt, tmodel, tparams, tindex, init)


def _share_vocab(jmodel, tmodel):
    for name in ("retriever_tokenizer", "generator_tokenizer"):
        jt, tt = getattr(jmodel, name), getattr(tmodel, name)
        tt.vocab, tt.inv = dict(jt.vocab), dict(jt.inv)


QUERIES = ["what is the value of e3", "what is the value of e17"]
TARGETS = ["v3", "v17"]


@pytest.mark.parametrize("index_dtype", ["int8r", "hybrid"])
def test_training_batch_matches_jax(tmp_path, index_dtype):
    """``retrieve_pair`` (one search over both towers' 2B queries),
    ``build_union`` and ``build_batch`` give the JAX ids and tensors."""
    (jopt, mesh, jmodel, jparams, jindex, _, topt, tmodel, tparams, tindex,
     _) = _pair(tmp_path, index_dtype)
    post_q = [f"{q} [SEP] {t}" for q, t in zip(QUERIES, TARGETS)]
    jpair = jmodel.retrieve_pair(jindex, jparams, QUERIES, post_q, 3)
    jbatch = jmodel.build_batch("jsa", jindex, jparams, QUERIES, TARGETS)
    _share_vocab(jmodel, tmodel)
    tpair = tmodel.retrieve_pair(tindex, tparams, QUERIES, post_q, 3)
    for a, b in zip(jpair[:2], tpair[:2]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert tpair[2] == jpair[2] and tpair[3] == jpair[3]
    ju, jv = jmodel.build_union(jpair[1], jpair[0])
    tu, tv = tmodel.build_union(tpair[1], tpair[0])
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tv, jv)
    tbatch = tmodel.build_batch("jsa", tindex, tparams, QUERIES, TARGETS)
    assert set(tbatch) == set(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]),
                                      err_msg=k)
    assert tmodel.last_info == jmodel.last_info


def _jax_draws(monkeypatch, fns, params, batch, rng):
    """Run the JAX jsa loss once eagerly and capture its MIS draws."""
    seen = {}
    orig = jmodes.mis_chain

    def spy(rng_, post, prior, log_lm, **kw):
        out = orig(rng_, post, prior, log_lm, **kw)
        seen["p"] = np.asarray(out[2]["proposals"])
        seen["u"] = np.asarray(out[2]["uniforms"])
        return out

    monkeypatch.setattr(jmodes, "mis_chain", spy)
    jmodes.jsa_loss(fns, params, batch, rng)
    monkeypatch.setattr(jmodes, "mis_chain", orig)
    return seen["p"], seen["u"]


@pytest.mark.parametrize("flags", [dict(), dict(decouple_encoder=True),
                                   dict(mis_topk=2, use_all_mis=False),
                                   dict(reduce_norm=True),
                                   dict(contrastive_learning=True,
                                        training_sample_num=2)])
def test_jsa_loss_and_grads_match_jax(tmp_path, monkeypatch, flags):
    """The jsa loss, its aux and every gradient leaf at ``model_size
    tiny`` against ``jax.value_and_grad``, on the JAX batch, with the JAX
    run's MIS draws replayed."""
    (jopt, mesh, jmodel, jparams, jindex, _, topt, tmodel, tparams, tindex,
     _) = _pair(tmp_path, **flags)
    jbatch = jmodel.build_batch("jsa", jindex, jparams, QUERIES, TARGETS)
    rng = jax.random.PRNGKey(5)
    props, unifs = _jax_draws(monkeypatch, jmodel.fns, jparams, jbatch, rng)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodes.jsa_loss(jmodel.fns, p, jbatch, rng),
        has_aux=True)(jparams)

    monkeypatch.setattr(tmodes, "draw_mis", lambda gen, post, n: (
        torch.from_numpy(props.astype(np.int64)),
        torch.from_numpy(np.array(unifs))))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tx = toptim.set_optim(topt, tparams)
    leaves = [t for t in tx.leaves if t.requires_grad]
    (tloss, taux), tgrads = tmodel.loss_and_grad_fn("jsa")(
        tparams, tbatch, tmodes.StepRng.from_seed(0, "cpu"), leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(np.asarray(taux[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    jflat = _flat(jgrads)
    got = dict(zip([p for p, t in zip(tx.paths, tx.leaves)
                    if t.requires_grad], tgrads))
    assert set(jflat) == set(tx.paths)
    scale: dict = {}
    for p, want in jflat.items():
        group = p[:2] if "retriever" in p[0] else p[:1]
        scale[group] = max(scale.get(group, 0.0), float(np.abs(want).max()))
    for p, want in jflat.items():
        g = got.get(p)
        g = np.zeros_like(want) if g is None else g.numpy()
        group = p[:2] if "retriever" in p[0] else p[:1]
        np.testing.assert_allclose(g, want, rtol=1e-4,
                                   atol=5e-4 * scale[group], err_msg=str(p))
    # the decaying-but-unused leaf: the prior passage tower gets no gradient
    # (it gets one under decouple, where the posterior reads it, and from
    # the contrastive negatives)
    prior_passage = got[("retriever", "passage", "layers", "0", "q_w")]
    assert (prior_passage is None) == (not topt.decouple_encoder
                                       and "neg_passage_ids" not in jbatch)


def test_mis_chain_and_empirical_distribution_match_jax():
    """The chain on given draws: sampled states, accept rate, empirical
    distribution, including the first step's forced accept."""
    rng = np.random.default_rng(2)
    b, u, n = 3, 6, 40
    post = rng.dirichlet(np.ones(u), b).astype(np.float32)
    prior = rng.dirichlet(np.ones(u), b).astype(np.float32)
    log_lm = -rng.uniform(0, 5, (b, u)).astype(np.float32)
    js, jrate, info = jmodes.mis_chain(
        jax.random.PRNGKey(1), jnp.asarray(post), jnp.asarray(prior),
        jnp.asarray(log_lm), mis_step=n, temperature_lm=0.7)
    ts, trate, tinfo = tmodes.mis_chain(
        torch.from_numpy(post), torch.from_numpy(prior),
        torch.from_numpy(log_lm),
        torch.from_numpy(np.asarray(info["proposals"]).astype(np.int64)),
        torch.from_numpy(np.array(info["uniforms"])), temperature_lm=0.7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tinfo["accepts"].numpy(),
                                  np.asarray(info["accepts"]))
    assert trate.item() == pytest.approx(float(jrate), rel=1e-6)
    for last_k in (None, 5):
        np.testing.assert_allclose(
            tmodes.empirical_distribution(ts, u, last_k).numpy(),
            np.asarray(jmodes.empirical_distribution(js, u, last_k)),
            rtol=0, atol=1e-7)
    p, un = tmodes.draw_mis(torch.Generator().manual_seed(0),
                            torch.from_numpy(post), 7)
    assert p.shape == un.shape == (7, b) and int(p.max()) < u


# ------------------------------------------------------------ checkpoints
def test_checkpoint_loads_across_packages(tmp_path):
    """A port ``save_checkpoint`` pickle loads with the JAX
    ``load_checkpoint`` and the reverse, leaf for leaf, with the
    posterior and LoRA trees under their keys; the port restores a JAX
    checkpoint into modules, and backfills a missing posterior from the
    restored prior."""
    kw = dict(model_size="tiny", max_vocab=300, gold_score_mode="jsa",
              decouple_encoder=True)
    jopt = jconfig.Options(**kw)
    _, jparams, _ = jmodel_io.load_or_initialize_model(jopt,
                                                       JStore.synthetic(8))
    jtree = jax.tree_util.tree_map(np.array, jparams)
    jckpt.save_checkpoint(str(tmp_path), "jax", 7, jparams)
    topt = tconfig.Options(device="cpu", name="t",
                           model_path=str(tmp_path / "jax"), **kw)
    tmodel, tparams, step = tmodel_io.load_or_initialize_model(
        topt, TStore.synthetic(8))
    assert step == 7 and set(tparams) == set(jtree)
    assert tparams["post_retriever"].tower_names() == ["query"]
    tckpt.save_checkpoint(str(tmp_path), "torch", 9, tparams, options=topt,
                          tokenizer=tmodel.generator_tokenizer)
    back = jckpt.load_checkpoint(str(tmp_path / "torch"))
    assert back["step"] == 9
    tflat, jflat = _flat(back["params"]), _flat(jtree)
    assert set(tflat) == set(jflat)
    for p in jflat:
        np.testing.assert_array_equal(tflat[p], jflat[p])
    assert os.readlink(tmp_path / "torch" / "latest") == "step-9"
    assert (tmp_path / "torch" / "step-9" / "options.json").exists()
    # a checkpoint without a posterior: backfilled from the restored prior
    state = dict(back, params={k: v for k, v in back["params"].items()
                               if k != "post_retriever"})
    os.makedirs(tmp_path / "nopost" / "step-1")
    with open(tmp_path / "nopost" / "step-1" / "state.pkl", "wb") as f:
        pickle.dump(state, f)
    topt.model_path = str(tmp_path / "nopost" / "step-1")
    _, p2, _ = tmodel_io.load_or_initialize_model(topt, TStore.synthetic(8))
    assert torch.equal(p2["post_retriever"].query.layers[0].q_w,
                       p2["retriever"].query.layers[0].q_w)
    assert (p2["post_retriever"].query.layers[0].q_w.data_ptr()
            != p2["retriever"].query.layers[0].q_w.data_ptr())
    tckpt.export_retriever(str(tmp_path / "exp"), 3, p2["retriever"])
    with open(tmp_path / "exp" / "bge_query_Embedding_Ret" / "lastest" /
              "params.pkl", "rb") as f:
        q = pickle.load(f)
    np.testing.assert_array_equal(q["layers"][0]["q_w"],
                                  jflat[("retriever", "query", "layers", "0",
                                         "q_w")])
    # the optimizer's state rides along (--save_optimizer) and loads in
    # the JAX package's loader as plain dicts and arrays
    tx = toptim.set_optim(topt, tparams)
    tckpt.save_checkpoint(str(tmp_path), "x", 1, tparams,
                          opt_state=tx.state_dict())
    got = jckpt.load_checkpoint(str(tmp_path / "x"))["opt_state"]
    assert got["count"] == 0 and set(got["mu"]) == set(got["nu"])
    key = "retriever/query/layers/0/q_w"
    assert got["mu"][key].shape == tparams["retriever"].query.layers[0] \
        .q_w.shape


def test_make_posterior_copies_or_shares():
    topt = tconfig.Options(device="cpu", model_size="tiny", max_vocab=300)
    _, params, _ = tmodel_io.load_or_initialize_model(topt,
                                                      TStore.synthetic(8))
    prior = params["retriever"]
    full = make_posterior(prior, decouple=False)
    assert full.tower_names() == ["query", "passage"]
    assert full.passage.layers[0].q_w.data_ptr() != \
        prior.passage.layers[0].q_w.data_ptr()
    fns = tmodes.ApplyFns(gen_cfg=None, decouple=True)
    view = fns.expand({"retriever": prior,
                       "post_retriever": make_posterior(prior,
                                                        decouple=True)})
    post = view["post_retriever"]
    assert post.passage is prior.passage and post.query is not prior.query


# ------------------------------------------------------------------ loops
def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("index_dtype", ["int8r", "hybrid"])
def test_three_step_loop_matches_jax(tmp_path, monkeypatch, index_dtype):
    """Three jsa steps of the JAX ``train`` loop and of the port's, from
    the same init and index, the port replaying the JAX run's MIS draws
    (``training_info_step{N}.json``, batch size 1): the same per-step
    losses and generator losses, and the same final params."""
    (jopt, mesh, jmodel, jparams, jindex, path, topt, tmodel, tparams,
     tindex, init) = _pair(tmp_path, index_dtype)
    jopt.load_index_path = path
    jparams, specs = jstep.setup_params(jopt, jparams, mesh)
    jtx, _ = joptim.set_optim(jopt, jparams)
    state = jstep.init_opt_state(jtx, jparams, specs, mesh)
    jparams, _, jsteps = jloop.train(jmodel, jindex, jparams, jtx, state,
                                     jopt, mesh=mesh)
    assert jsteps == 3
    jdir = tmp_path / "ck" / "run"
    draws = []
    for s in (1, 2, 3):
        with open(jdir / f"training_info_step{s}.json") as f:
            info = json.load(f)
        draws.append((np.asarray(info["debug/proposal_ids"], np.int64),
                      np.asarray(info["debug/uniform_draws"], np.float32)))

    def replay(gen, post, n):
        p, u = draws.pop(0)
        assert len(p) == n and post.shape[0] == 1
        return torch.from_numpy(p[:, None]), torch.from_numpy(u[:, None])

    monkeypatch.setattr(tmodes, "draw_mis", replay)
    _share_vocab(jmodel, tmodel)
    topt.name = "torch"
    topt.load_index_path = path
    tx = toptim.set_optim(topt, tparams)
    assert tloop.train(tmodel, tindex, tparams, tx, topt) == 3
    assert not draws
    jm = _metrics(jdir / "metrics.jsonl")
    tm = _metrics(tmp_path / "ck" / "torch" / "metrics.jsonl")
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == [1, 2, 3]
    for a, b in zip(tm, jm):
        for k in ("loss/train_loss", "loss/generator_loss", "accept_rate"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    want = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    got = _flat(convert.params_to_numpy(tparams))
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-5,
                                   err_msg=str(p))
    # frozen leaves bit-identical; the unused prior passage tower decayed
    init_flat = _flat(init)
    for p in want:
        if p[0] == "generator" or p[:2] == ("post_retriever", "passage"):
            np.testing.assert_array_equal(got[p], init_flat[p])
    decay = np.prod([1 - tx.lr("retr", c) * topt.weight_decay
                     for c in range(3)])
    p = ("retriever", "passage", "layers", "0", "q_w")
    np.testing.assert_allclose(got[p], init_flat[p] * decay, rtol=1e-6)


def test_train_cli_runs_and_defaults_to_cuda(tmp_path):
    """``python -m jsa_rag_tpu_torch.train`` end to end on the CPU (hybrid
    index built in the loop, refreshed at step 2, a checkpoint at step 3)
    — and without ``--device`` it asks for cuda, which raises here."""
    kw = _kw(tmp_path, "hybrid", total_steps=3, save_freq=3,
             refresh_index="0-4:2")
    argv = []
    for k, v in kw.items():
        argv += [f"--{k}"] + ([str(x) for x in v] if isinstance(v, list)
                              else [str(v)])
    assert tmain(argv + ["--device", "cpu"]) == 3
    run = tmp_path / "ck" / "run"
    assert (run / "latest" / "state.pkl").exists()
    with open(run / "training_info_step1.json") as f:
        info = json.load(f)
    assert len(info["debug/proposal_ids"]) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmain(argv)


# ---------------------------------------------------------------- resume
@pytest.mark.parametrize("accumulation", [1, 2])
def test_resume_matches_uninterrupted_runs(tmp_path, monkeypatch,
                                           accumulation):
    """Three jsa steps saved with ``--save_optimizer``, then a resume from
    that checkpoint (``load_or_initialize_model`` -> ``set_optim``) for
    three more: the final params equal six uninterrupted steps of the port,
    leaf by leaf, and of the JAX loop with its MIS draws replayed (1e-5, as
    the three-step loop). Epochs of 4 batches, so the resume skips into the
    first epoch and crosses into the second; at accumulation 2 the save
    falls inside an accumulation window."""
    (jopt, mesh, jmodel, jparams, jindex, path, topt, tmodel, tparams,
     tindex, init) = _pair(tmp_path, n_train=4, total_steps=6,
                           log_detail_num=6,
                           accumulation_steps=accumulation)
    jopt.load_index_path = path
    jparams, specs = jstep.setup_params(jopt, jparams, mesh)
    jtx, _ = joptim.set_optim(jopt, jparams)
    state = jstep.init_opt_state(jtx, jparams, specs, mesh)
    jparams, _, jsteps = jloop.train(jmodel, jindex, jparams, jtx, state,
                                     jopt, mesh=mesh)
    assert jsteps == 6
    draws = []
    for s in range(1, 7):
        with open(tmp_path / "ck" / "run" / f"training_info_step{s}.json") as f:
            info = json.load(f)
        draws.append((np.asarray(info["debug/proposal_ids"], np.int64),
                      np.asarray(info["debug/uniform_draws"], np.float32)))
    queue = []

    def replay(gen, post, n):
        p, u = queue.pop(0)
        assert len(p) == n and post.shape[0] == 1
        return torch.from_numpy(p[:, None]), torch.from_numpy(u[:, None])

    monkeypatch.setattr(tmodes, "draw_mis", replay)
    _share_vocab(jmodel, tmodel)
    topt.load_index_path = path

    def run(name, total, params, model, tx, step=0, **flags):
        o = tconfig.Options(**{**vars(topt), "name": name,
                               "total_steps": total, **flags})
        index = load_index(path, device="cpu", refine_r=o.refine_r,
                           int8r_refine=o.int8r_refine)
        return tloop.train(model, index, params, tx, o, step=step)

    # six uninterrupted steps
    queue[:] = draws
    full = convert.params_from_numpy(init, tmodel.retriever.cfg)
    assert run("full", 6, full, tmodel, toptim.set_optim(topt, full)) == 6
    # three steps, saved with the optimizer's state at step 3
    queue[:] = draws[:3]
    part = convert.params_from_numpy(init, tmodel.retriever.cfg)
    assert run("part", 3, part, tmodel, toptim.set_optim(topt, part),
               save_freq=3, save_optimizer=True) == 3
    assert not queue
    # the resume: model, params and optimizer state from the checkpoint
    ropt = tconfig.Options(**{**vars(topt), "name": "part",
                              "model_path": str(tmp_path / "ck" / "part")})
    rmodel, rparams, step, ostate = tmodel_io.load_or_initialize_model(
        ropt, TStore.from_jsonl(ropt.passages), with_opt_state=True)
    assert step == 3 and ostate["count"] == 3 // accumulation
    assert ostate["mini_step"] == 3 % accumulation
    assert bool(ostate["acc"]) == (accumulation == 2)
    rtx = toptim.set_optim(ropt, rparams, ostate, step)
    queue[:] = draws[3:]
    assert run("part", 6, rparams, rmodel, rtx, step=step) == 6
    assert not queue and rtx.count == 6 // accumulation

    got = _flat(convert.params_to_numpy(rparams))
    ref = _flat(convert.params_to_numpy(full))
    want = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(got) == set(ref) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], ref[p], rtol=0, atol=1e-6,
                                   err_msg=str(p))
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-5,
                                   err_msg=str(p))


def test_resume_without_opt_state_starts_the_schedule_at_the_step():
    """A checkpoint with no optimizer state of the port (none, or the JAX
    package's optax one): the update count is the restored step's updates
    (the loop takes one micro-step a step), so the LR schedule goes on from
    there with zero moments; the port's own state restores its count."""
    opt = tconfig.Options(device="cpu", model_size="tiny", max_vocab=300,
                          warmup_steps=4, total_steps=20,
                          accumulation_steps=2, scheduler="linear")
    _, params, _ = tmodel_io.load_or_initialize_model(opt,
                                                      TStore.synthetic(8))
    tx = toptim.set_optim(opt, params, None, step=7)
    assert tx.count == 3 and tx.mini_step == 0
    fresh = toptim.set_optim(opt, params)
    assert tx.lr("lm") == fresh.lr("lm", 3) != fresh.lr("lm")
    assert all(float(m.abs().max()) == 0 for m in tx.mu if m is not None)
    jax_form = {"inner_opt_state": (), "mini_step": 1}  # not the port's
    assert toptim.set_optim(opt, params, jax_form, step=9).count == 4
    tx.count, tx.mini_step = 5, 1
    again = toptim.set_optim(opt, params, tx.state_dict(), step=11)
    assert (again.count, again.mini_step) == (5, 1)
    with pytest.raises(ValueError, match="accumulates"):
        toptim.AdamW(tconfig.Options(**{**vars(opt),
                                        "accumulation_steps": 1}),
                     params).load_state_dict(tx.state_dict())


_LOAD_WITHOUT_JAX = """
import sys
for name in ("jax", "jaxlib", "optax", "chex", "ml_dtypes"):
    sys.modules[name] = None
from jsa_rag_tpu_torch.train import checkpoint
state = checkpoint.load_checkpoint(sys.argv[1])
assert "opt_state" not in state, sorted(state)
leaf = state["params"]["retriever"]["query"]["layers"][0]["q_w"]
print(state["step"], leaf.shape[0], leaf.dtype)
"""


def test_jax_checkpoint_with_optax_state_loads_without_jax(tmp_path):
    """A JAX ``state.pkl`` written with ``--save_optimizer`` pickles optax
    classes; in a process where jax and optax cannot be imported the port
    loads its step and params (the optax state dropped)."""
    import subprocess
    import sys

    jopt = jconfig.Options(model_size="tiny", max_vocab=300,
                           gold_score_mode="jsa")
    _, jparams, _ = jmodel_io.load_or_initialize_model(jopt,
                                                       JStore.synthetic(8))
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jparams, specs = jstep.setup_params(jopt, jparams, mesh)
    jtx, _ = joptim.set_optim(jopt, jparams)
    state = jstep.init_opt_state(jtx, jparams, specs, mesh)
    jckpt.save_checkpoint(str(tmp_path), "jax", 12, jparams, opt_state=state)
    with open(tmp_path / "jax" / "latest" / "state.pkl", "rb") as f:
        assert b"optax" in f.read()
    out = subprocess.run(
        [sys.executable, "-c", _LOAD_WITHOUT_JAX, str(tmp_path / "jax")],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    hidden = jparams["retriever"]["query"]["layers"][0]["q_w"].shape[0]
    assert out.stdout.split() == ["12", str(hidden), "float32"]
