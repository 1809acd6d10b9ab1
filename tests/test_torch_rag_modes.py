"""Port parity of the rag, vrag and concat training modes, the
double-buffered refresh and pipelined retrieval, against the JAX package on
the CPU over a float16 flat index.

Routes. Searches run the exact f32 scan over the stored fp16 values on both
sides (``method="auto"`` on the CPU); the refreshers' embeddings run each
package's passage tower. Dropout is 0, so rag, vrag and concat are
deterministic (no MIS draws): the loops are compared without replay.

vrag's posterior starts as a copy of the prior, where KL(post || prior) and
its gradient are zero and the prior tower would receive float rounding
only; the vrag tests therefore move the posterior's matrices off the copy
(N(0, 0.1) added; at the init's own 0.02 the two distributions still
differ by ~1e-6 and their difference is mostly rounding) before either
package runs.

Tolerances. Batches, ids and masks are equal. Losses agree to 1e-5
relative. Generator and LoRA gradients leaf by leaf to 1e-4 relative plus
5e-4 of the largest JAX gradient of their tree absolute (those of
``test_torch_train``: float32 sums in another order). Retriever gradients:
in rag and vrag a tower's gradient runs through p_z - w_z, the prior (or
posterior) minus its CE-reweighted version, which at random init differ by
~1e-3 because each passage's CE differs by ~1e-3 nats; a float32 rounding
of a CE (~1e-6 relative) becomes ~1e-3 of that gradient (measured up to
5.3e-3 of a tower's norm, 2.8e-3 with the vrag posterior moved). So per
tower the L2 error is within 2e-2 of the
JAX gradient's norm and each element within 2e-2 of the tower's largest.
Loops: per-step losses to 1e-4 relative (the vrag KL also 1e-6 absolute);
final generator/LoRA params to 1e-5 absolute; retriever params to 1e-5
plus 2e-2 x lr x steps (Adam moves a weight by ~lr per step, and a
gradient element off by a relative d moves its update by ~d x lr).
Refreshed stores: fp16 rows one
ulp apart at most, or 1e-5 where an ulp is finer (the towers agree to
1e-5), in under 2% of cells; int8 codes one step apart in under 2% of
cells, scales to 1e-4 relative (one tower ulp moves a row's max)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu import model_io as jmodel_io
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.index import build_index_for as jbuild_index_for
from jsa_rag_tpu.index.refresh import (IncrementalIndexRefresher as
                                       JRefresher)
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.train import loop as jloop
from jsa_rag_tpu.train import modes as jmodes
from jsa_rag_tpu.train import optim as joptim
from jsa_rag_tpu.train import step as jstep
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
from jsa_rag_tpu_torch.index import build_index_for as tbuild_index_for
from jsa_rag_tpu_torch.index.refresh import (IncrementalIndexRefresher as
                                             TRefresher)
from jsa_rag_tpu_torch.ops import mips_topt as tp2
from jsa_rag_tpu_torch.train import loop as tloop
from jsa_rag_tpu_torch.train import modes as tmodes
from jsa_rag_tpu_torch.train import optim as toptim

from test_torch_mips import assert_same_topk
from test_torch_train import (QUERIES, TARGETS, _flat, _kw, _metrics, _pair,
                              _share_vocab)

MODES = {"rag": dict(gold_score_mode="rag"),
         "vrag": dict(gold_score_mode="vrag"),
         "concat": dict(gold_score_mode="rag", gen_method="concat")}


RETRIEVER_GRAD_TOL = 2e-2


def _perturb_posterior(init, seed=7):
    """The init with N(0, 0.1) added to the posterior's matrices."""
    rng = np.random.default_rng(seed)
    return dict(init, post_retriever=jax.tree_util.tree_map(
        lambda w: (w + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)
        if w.ndim == 2 else w, init["post_retriever"]))


def _pair_for(tmp_path, mode, **flags):
    """``_pair`` over a float16 index, the vrag posterior moved off its
    prior copy in both packages' params."""
    out = list(_pair(tmp_path, "float16", **MODES[mode], **flags))
    if mode == "vrag":
        init = _perturb_posterior(out[10])
        out[3] = jax.tree_util.tree_map(jnp.asarray, init)
        out[8] = convert.params_from_numpy(init, out[7].retriever.cfg)
        out[10] = init
    return out


def _compare_grads(tx, tgrads, jgrads):
    jflat = _flat(jgrads)
    got = dict(zip([p for p, t in zip(tx.paths, tx.leaves)
                    if t.requires_grad], tgrads))
    assert set(jflat) == set(tx.paths)
    groups: dict = {}
    for p, want in jflat.items():
        g = got.get(p)
        g = np.zeros_like(want) if g is None else g.numpy()
        group = p[:2] if "retriever" in p[0] else p[:1]
        groups.setdefault(group, []).append((p, g, want))
    for group, leaves in groups.items():
        scale = max(float(np.abs(w).max()) for _, _, w in leaves)
        if "retriever" not in group[0]:
            for p, g, want in leaves:
                np.testing.assert_allclose(g, want, rtol=1e-4,
                                           atol=5e-4 * scale, err_msg=str(p))
            continue
        err = sum(float(((g - w) ** 2).sum()) for _, g, w in leaves) ** 0.5
        norm = sum(float((w ** 2).sum()) for _, _, w in leaves) ** 0.5
        assert err <= RETRIEVER_GRAD_TOL * norm, (group, err, norm)
        for p, g, want in leaves:
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=RETRIEVER_GRAD_TOL * scale,
                                       err_msg=str(p))
    return got


@pytest.mark.parametrize("mode,flags,post_valid", [
    ("concat", {}, False),
    ("rag", {}, False),
    ("vrag", {}, False),                       # union_kl on
    ("vrag", dict(union_kl=False), False),
    ("vrag", dict(standard_mc=True, temperature_score=0.5), False),
    ("vrag", dict(decouple_encoder=True), False),
    ("vrag", {}, True),
    ("vrag", dict(union_kl=False, temperature_score=0.5), True),
])
def test_loss_and_grads_match_jax(tmp_path, mode, flags, post_valid):
    """Each mode's loss, its aux and every gradient leaf at ``model_size
    tiny`` against ``jax.value_and_grad`` on the JAX batch. ``post_valid``
    masks supplied-list pads out of vrag's posterior (and, without the
    union KL, its prior)."""
    (_, _, jmodel, jparams, jindex, _, topt, tmodel, tparams, _,
     _) = _pair_for(tmp_path, mode, **flags)
    jbatch = jmodel.build_batch(mode, jindex, jparams, QUERIES, TARGETS)
    if post_valid:
        jbatch["post_valid"] = jnp.asarray([[True, True, False],
                                            [True, False, True]])
    rng = jax.random.PRNGKey(5)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jmodes.MODE_LOSSES[mode](jmodel.fns, p, jbatch, rng),
        has_aux=True)(jparams)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tx = toptim.set_optim(topt, tparams)
    leaves = [t for t in tx.leaves if t.requires_grad]
    (tloss, taux), tgrads = tmodel.loss_and_grad_fn(mode)(
        tparams, tbatch, tmodes.StepRng.from_seed(0, "cpu"), leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    assert set(taux) == set(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = _compare_grads(tx, tgrads, jgrads)
    retriever = [g for p, g in got.items() if "retriever" in p[0]]
    if mode == "concat":  # no retriever gradient at all
        assert retriever and all(g is None for g in retriever)
    else:
        assert any(g is not None and bool(g.abs().sum() > 0)
                   for g in retriever)


@pytest.mark.parametrize("mode,flags", [
    ("rag", {}), ("concat", {}), ("vrag", {}),
    ("vrag", dict(union_kl=False))])
def test_training_batch_matches_jax(tmp_path, mode, flags):
    """``retrieval_ctx``/``build_batch`` of each mode give the JAX ids,
    passages and tensors over the float16 index."""
    (_, _, jmodel, jparams, jindex, _, _, tmodel, tparams, tindex,
     _) = _pair_for(tmp_path, mode, **flags)
    jctx = jmodel.retrieval_ctx(mode, jindex, jparams, QUERIES, TARGETS)
    jbatch = jmodel.build_batch(mode, jindex, jparams, QUERIES, TARGETS,
                                retrieval=jctx)
    _share_vocab(jmodel, tmodel)
    tctx = tmodel.retrieval_ctx(mode, tindex, tparams, QUERIES, TARGETS)
    for key in ("passages", "u_passages", "post_passages", "post_queries",
                "use_file"):
        assert tctx.get(key) == jctx.get(key), key
    if "valid" in jctx:
        np.testing.assert_array_equal(tctx["valid"], jctx["valid"])
    tbatch = tmodel.build_batch(mode, tindex, tparams, QUERIES, TARGETS,
                                retrieval=tctx)
    assert set(tbatch) == set(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(),
                                      np.asarray(jbatch[k]), err_msg=k)
    assert tmodel.last_info == jmodel.last_info


def _run_loops(tmp_path, mode, **over):
    """The JAX ``train`` loop and the port's from the same init and saved
    float16 index -> (JAX metrics, port metrics, JAX params, port params,
    init, port optimizer, port options)."""
    (jopt, mesh, jmodel, jparams, jindex, path, topt, tmodel, tparams,
     tindex, init) = _pair_for(tmp_path, mode, **over)
    jopt.load_index_path = path
    jparams, specs = jstep.setup_params(jopt, jparams, mesh)
    jtx, _ = joptim.set_optim(jopt, jparams)
    state = jstep.init_opt_state(jtx, jparams, specs, mesh)
    jparams, _, jsteps = jloop.train(jmodel, jindex, jparams, jtx, state,
                                     jopt, mesh=mesh)
    assert jsteps == jopt.total_steps
    _share_vocab(jmodel, tmodel)
    topt.name = "torch"
    topt.load_index_path = path
    tx = toptim.set_optim(topt, tparams)
    assert tloop.train(tmodel, tindex, tparams, tx, topt) == topt.total_steps
    jm = _metrics(tmp_path / "ck" / "run" / "metrics.jsonl")
    tm = _metrics(tmp_path / "ck" / "torch" / "metrics.jsonl")
    assert [m["step"] for m in tm] == [m["step"] for m in jm] == list(
        range(1, topt.total_steps + 1))
    for a, b in zip(tm, jm):
        assert {k for k in a if not k.startswith("runtime/")} == \
            {k for k in b if not k.startswith("runtime/")}
        for k in ("loss/train_loss", "loss/generator_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        if "KL" in b:
            np.testing.assert_allclose(a["KL"], b["KL"], rtol=1e-4,
                                       atol=1e-6)
    want = _flat(jax.tree_util.tree_map(np.asarray, jparams))
    got = _flat(convert.params_to_numpy(tparams))
    slack = RETRIEVER_GRAD_TOL * max(topt.lr, topt.lr_retriever) * len(tm)
    for p in want:
        atol = 1e-5 + (slack if "retriever" in p[0] else 0.0)
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=atol,
                                   err_msg=str(p))
    return jm, tm, got, init, tx, topt


@pytest.mark.parametrize("mode,steps", [("rag", 3), ("vrag", 2),
                                        ("concat", 2)])
def test_loop_matches_jax(tmp_path, mode, steps):
    """``steps`` steps of both training loops in each mode: the same
    per-step losses and final params; the frozen leaves bit-identical
    (generator base; vrag's posterior passage tower); under concat every
    retriever leaf only decays, init x prod(1 - lr_t * wd) of its group."""
    _, _, got, init, tx, topt = _run_loops(tmp_path, mode,
                                           total_steps=steps)
    init_flat = _flat(init)
    for p in got:
        if p[0] == "generator" or p[:2] == ("post_retriever", "passage"):
            np.testing.assert_array_equal(got[p], init_flat[p],
                                          err_msg=str(p))
        elif mode == "concat" and "retriever" in p[0]:
            label = tx.labels[tx.paths.index(p)]
            decay = np.prod([np.float32(1) - np.float32(tx.lr(label, c))
                             * np.float32(topt.weight_decay)
                             for c in range(steps)], dtype=np.float32)
            np.testing.assert_allclose(got[p], init_flat[p] * decay,
                                       rtol=1e-6, err_msg=str(p))
        else:
            assert not np.array_equal(got[p], init_flat[p]), p


def test_loop_with_incremental_refresh_and_pipeline_matches_jax(tmp_path):
    """rag over float16 with ``--refresh_index 0-10:2
    --incremental_refresh_batches 2 --pipeline_retrieval true``: the sweep
    starts at step 2 (48 passages, 2 batches of 16 a step) and swaps at
    step 3 in both loops; the prefetch made against the pre-swap rows is
    dropped; the per-step losses and final params match."""
    jm, tm, *_ = _run_loops(
        tmp_path, "rag", total_steps=4, refresh_index="0-10:2",
        incremental_refresh_batches=2, per_gpu_embedder_batch_size=16,
        pipeline_retrieval=True)
    for m in (jm, tm):
        assert [x["step"] for x in m if "index/refresh_swapped" in x] == [3]
        assert [x["step"] for x in m if "runtime/incremental_refresh" in x] \
            == [2, 3, 4]
        assert all("runtime/prefetch_retrieve" in x for x in m[:-1])


def _stored(idx):
    """The refreshed store of either package as numpy, row-major:
    (rows, scales) — fp16 rows as int16 bits, int8 codes; scales None for
    fp16, plane 1's for int8r (plane 2 appended)."""
    n = idx.n_passages
    if hasattr(idx, "mesh"):  # the JAX index
        e = np.asarray(idx.embeddings)
        e = e[:n] if idx.store_hybrid else e[:, :n].T
        if idx.store_int8r:
            return (np.concatenate([e, np.asarray(idx.res)[:n]], axis=1),
                    np.concatenate([np.asarray(idx.scales)[0, :n],
                                    np.asarray(idx.res_scales)[0, :n]]))
        return e, (np.asarray(idx.scales)[0, :n] if idx.store_int8
                   else None)
    e = idx.embeddings[:n]
    if idx.dtype == torch.float16:
        return e.view(torch.int16).numpy(), None
    if idx.store_int8r:
        return (torch.cat([e, idx.res[:n]], dim=1).numpy(),
                torch.cat([idx.scales[0, :n], idx.res_scales[0, :n]]).numpy())
    return e.numpy(), idx.scales[0, :n].numpy()


@pytest.mark.parametrize("index_dtype", ["float16", "int8r", "int8",
                                         "hybrid"])
def test_refresher_matches_jax(tmp_path, index_dtype):
    """``IncrementalIndexRefresher`` against the JAX package's, from the
    same tower weights into an empty index: the sweep swaps at the same
    step (48 passages, 2 batches of 16 a step: the second), the stores
    agree and search alike; hybrid's coarse copy is derived again from the
    swapped-in rows."""
    kw = _kw(tmp_path, index_dtype, per_gpu_embedder_batch_size=16)
    jopt = jconfig.Options(**kw)
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jstore = JStore.from_jsonl(jopt.passages)
    jmodel, jparams, _ = jmodel_io.load_or_initialize_model(jopt, jstore)
    hidden = jmodel.retriever.cfg.bert.hidden
    jindex = jbuild_index_for(jopt, len(jstore), hidden, mesh)
    topt = tconfig.Options(device="cpu", **kw)
    tmodel, _, _ = tmodel_io.load_or_initialize_model(
        topt, TStore.from_jsonl(topt.passages))
    tparams = convert.params_from_numpy(
        jax.tree_util.tree_map(np.array, jparams), tmodel.retriever.cfg)
    tindex = tbuild_index_for(topt, len(jstore), hidden, device="cpu")
    _share_vocab(jmodel, tmodel)
    if index_dtype == "hybrid":
        tindex.hybrid_copies()  # derived once from the empty rows
    steps = []
    for refresher, params in ((JRefresher(jmodel, jindex, 2), jparams),
                              (TRefresher(tmodel, tindex, 2), tparams)):
        assert not refresher.active
        refresher.start()
        n = 1
        while not refresher.step(params):
            n += 1
            assert refresher.active and n < 10
        assert not refresher.active
        steps.append(n)
    assert steps == [2, 2]
    (jrows, jsc), (trows, tsc) = _stored(jindex), _stored(tindex)
    assert (trows != jrows).mean() < 0.02
    if jsc is None:  # fp16 rows: one ulp, or 1e-5 where an ulp is finer
        a, b = trows.view(np.float16), jrows.view(np.float16)
        assert (np.abs(a.astype(np.float32) - b.astype(np.float32))
                <= np.maximum(np.spacing(np.abs(b)).astype(np.float32),
                              1e-5)).all()
        assert (np.abs(b[:4].astype(np.float32)) > 0).any()
    else:
        assert np.abs(trows.astype(np.int32) - jrows.astype(np.int32)
                      ).max() <= 1
        np.testing.assert_allclose(tsc, jsc, rtol=1e-4)
    q = tindex.embeddings_as_float()[[1, 20, 40]].numpy()
    js, ji = jindex.search(jnp.asarray(q), 5)
    ts, ti = tindex.search(q, 5)
    # one stored ulp or code step moves a unit-row score by < 1e-2
    assert_same_topk(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji),
                     tol=1e-2)
    if index_dtype == "hybrid":
        codes, scales = tindex.hybrid_copies()
        want_v, want_s = tp2.hybrid_int8_from_f16(tindex.embeddings)
        assert tindex.hybrid_derivations == 2
        assert torch.equal(codes, want_v) and torch.equal(scales[0], want_s)
