"""Port parity of the sharded placements: FSDP (``--shard_optim``) and
Megatron tensor parallelism (``--tensor_parallel``) over gloo CPU
processes started with ``torchrun``'s environment contract
(``parallel/dryrun.py::start``), against the JAX package on the virtual
CPU mesh of ``conftest.py`` in this process. The workers import torch and
the port only; each runs under a timeout of 60 s, so a desync fails
instead of hanging.

- (a) ``tests/test_sharding.py``'s cases at its widths (vocab 128, hidden
  32, 2 layers, 4 heads): the tensor-parallel forward on two ranks equals
  the one-process forward and the JAX one within 2e-4; FSDP splits
  ``embed`` by rows and AdamW's moments follow; leaves that share storage
  are placed on storage of their own.
- (b) The port's spec trees equal the JAX ``PartitionSpec`` trees leaf for
  leaf (pure functions, no processes): GQA, gpt2, and a generator whose
  ``kv_heads`` the index axis does not divide (where the port's placement
  replicates the attention leaves, a Known difference).
- (c) One jsa and one rag step, dropout off, the JAX run's MIS draws
  replayed, LoRA adapters non-zero: ``--shard_optim`` on (2, 1) against
  the JAX step on a (2, 1) mesh under ``shard_optim``, and bit-equal to the
  port's own DDP step where the clip does not trigger;
  ``--tensor_parallel`` on (1, 2) against the JAX step on a (1, 2) mesh;
  one rag step on four processes on (2, 2) with both flags. The loss
  within 1e-5 relative, the aux within 1e-4 relative and 1e-6 absolute,
  the updated params (gathered) within 1e-5 absolute
  (``tests/test_torch_train.py``'s tolerances).
- (d) A ``--shard_optim --save_optimizer`` checkpoint written by two ranks
  through ``train.__main__.main``: the full tree, which the JAX package
  loads; the resume on two ranks lands each rank's shards of the params
  and of mu and nu on the saved values.
"""

import json
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu import model_io as jmodel_io
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.index import build_index_for as jbuild_index_for
from jsa_rag_tpu.models.lm import LMConfig as JLMConfig
from jsa_rag_tpu.models.lm import lm_init as jlm_init
from jsa_rag_tpu.models.lm import lm_logits as jlm_logits
from jsa_rag_tpu.parallel import sharding as jsharding
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.train import modes as jmodes
from jsa_rag_tpu.train import optim as joptim
from jsa_rag_tpu.train import step as jstep
from jsa_rag_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
from jsa_rag_tpu_torch.models.lm import LMConfig
from jsa_rag_tpu_torch.parallel import dryrun, mesh, sharding
from jsa_rag_tpu_torch.train import step as tstep

from test_torch_train import _flat, _kw

TIMEOUT = 60
ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
CFG = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=4,
           intermediate=64)

WORKER = r"""
import json, os, pickle, sys
import numpy as np, torch
from jsa_rag_tpu_torch import config as tconfig, convert
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore
from jsa_rag_tpu_torch.parallel import mesh, sharding
from jsa_rag_tpu_torch.train import modes as tmodes
from jsa_rag_tpu_torch.train.optim import AdamW, named_leaves, set_optim
from jsa_rag_tpu_torch.train.step import make_train_step, place_params
torch.set_num_threads(1)
out_dir, tag = sys.argv[1], sys.argv[2]
with open(os.path.join(out_dir, tag + ".json")) as f:
    cfg = json.load(f)
mesh.init_processes("cpu", timeout_s=50)
r = mesh.process_index()
grid = mesh.make_grid(*cfg["grid"])
d = grid.data_rank
real_draw = tmodes.draw_mis
out = {}
for case in cfg["cases"]:
    with open(os.path.join(out_dir, case["ref"]), "rb") as f:
        ref = pickle.load(f)
    kw = dict(ref["kw"], **case["flags"])
    topt = tconfig.Options(device="cpu", **kw)
    model, _, _ = tmodel_io.load_or_initialize_model(
        topt, PassageStore.from_jsonl(topt.passages))
    params = convert.params_from_numpy(ref["init"], model.retriever.cfg)
    placement = place_params(topt, model, params, grid)
    tx = set_optim(topt, params, placement=placement)
    b = ref["rows"] // grid.n_data
    batch = {}
    for k, v in ref["batch"].items():
        per = v.shape[0] // ref["rows"]
        batch[k] = torch.from_numpy(np.array(v[d * b * per:(d + 1) * b * per]))
    tmodes.draw_mis = real_draw
    if "proposals" in ref:
        p = ref["proposals"][:, d * b:(d + 1) * b].astype(np.int64)
        u = np.array(ref["uniforms"][:, d * b:(d + 1) * b])
        tmodes.draw_mis = lambda gen, post, n: (torch.from_numpy(p),
                                                torch.from_numpy(u))
    step = make_train_step(model, ref["mode"], tx)
    loss, aux = step(params, batch, tmodes.StepRng.from_seed(0, "cpu"))
    leaves = named_leaves(params)
    res = {"loss": float(loss), "norm": float(tx.norm),
           "aux": {k: float(v) for k, v in aux.items()
                   if not k.startswith("debug/")},
           "specs": {"/".join(k): v for k, v in zip(placement.paths,
                                                     placement.specs)},
           "shapes": {"/".join(k): tuple(t.shape) for k, t in leaves.items()},
           "mu": {"/".join(k): tuple(m.shape) for k, m in
                  zip(tx.paths, tx.mu) if m is not None},
           "resident": placement.resident_bytes()}
    placement.gather_()
    res["params"] = convert.params_to_numpy(params)
    out[case["name"]] = res

if cfg.get("lm"):  # (a) the tensor-parallel forward and the FSDP moments
    from jsa_rag_tpu_torch.models import lm
    with open(os.path.join(out_dir, "lm.pkl"), "rb") as f:
        lmref = pickle.load(f)
    lcfg = lm.LMConfig(dtype=torch.float32, **lmref["cfg"])
    full = convert.lm_params_from_numpy(lmref["params"], "cpu")
    ids, mask = (torch.from_numpy(lmref[k]) for k in ("ids", "mask"))
    one = lm.lm_logits(full, lcfg, ids, mask).numpy()
    if grid.n_index > 1:
        _, group = mesh.axis_groups(grid)
        specs = sharding.whole_heads(sharding.lm_tp_specs(full, 2), lcfg, 2)
        tp = sharding.tensor_parallel_of(specs, group, 2, r)
        mine = convert.lm_params_from_numpy(lmref["params"], "cpu")
        def narrow(t, s):
            if s is None:
                return t
            n = t.shape[s.dim] // 2
            return t.narrow(s.dim, r * n, n).clone()
        mine = {k: (narrow(v, specs[k]) if k != "layers" else
                    [{n: narrow(w, specs["layers"][i][n])
                      for n, w in layer.items()}
                     for i, layer in enumerate(v)])
                for k, v in mine.items()}
        got = lm.lm_logits(mine, lm.with_tensor_parallel(lcfg, tp), ids,
                           mask).numpy()
        out["lm"] = {"one": one, "tp": got,
                     "q_w": tuple(mine["layers"][0]["q_w"].shape)}
    else:
        opt = tconfig.Options(device="cpu", shard_optim=True, use_lora=False)
        params = {"generator": full}
        leaves = named_leaves(params)
        specs = [sharding.fsdp_specs(t, 2) for t in leaves.values()]
        pl = sharding.place(list(leaves), list(leaves.values()), specs, grid)
        tx = AdamW(opt, params, pl)
        emb = list(leaves).index(("generator", "embed"))
        shared = torch.ones((16, 8))
        try:
            sharding.place(["a", "b"], [shared, shared], [None, None], grid)
            twice = "placed"
        except ValueError as err:
            twice = str(err)
        tree = {"prior": {"w": shared}, "post": {"w": shared.view(16, 8)},
                "split": {"w": torch.arange(32.0).reshape(8, 4)}}
        tl = named_leaves(tree)
        src = tree["split"]["w"].untyped_storage().data_ptr()
        al = sharding.place(list(tl), list(tl.values()),
                            [None, None, sharding.Split(0, "data")], grid)
        ptrs = [t.untyped_storage().data_ptr() for t in tl.values()]
        out["lm"] = {"one": one, "embed_spec": pl.specs[emb],
                     "embed": tuple(full["embed"].shape),
                     "mu": tuple(tx.mu[emb].shape),
                     "distinct": len(set(ptrs)) == 3, "twice": twice,
                     "not_input": src not in ptrs,
                     "values": [tree["prior"]["w"].tolist(),
                                tree["post"]["w"].tolist(),
                                tree["split"]["w"].tolist()]}

if cfg.get("ckpt"):  # (d) a sharded --save_optimizer run, then its resume
    from jsa_rag_tpu_torch.train.__main__ import main
    main(cfg["ckpt"])
    argv = list(cfg["ckpt"])
    argv += ["--model_path", os.path.join(argv[argv.index("--checkpoint_dir")
                                              + 1], "fsdp")]
    opt = tconfig.Options.from_args(argv)
    opt.device = "cpu"
    model, params, step, opt_state = tmodel_io.load_or_initialize_model(
        opt, PassageStore.from_jsonl(opt.passages), with_opt_state=True)
    placement = place_params(opt, model, params, grid)
    tx = set_optim(opt, params, opt_state, step, placement)
    out["resume"] = {
        "step": step, "count": tx.count,
        "params": {"/".join(k): t.detach().numpy().copy()
                   for k, t in zip(placement.paths, placement.leaves)},
        "mu": {"/".join(k): m.numpy().copy() for k, m in
               zip(tx.paths, tx.mu) if m is not None},
        "nu": {"/".join(k): m.numpy().copy() for k, m in
               zip(tx.paths, tx.nu) if m is not None},
        "specs": {"/".join(k): v for k, v in zip(placement.paths,
                                                  placement.specs)},
        "coord": [grid.data_rank, grid.index_rank]}
with open(os.path.join(out_dir, f"{tag}_{r}.pkl"), "wb") as f:
    pickle.dump(out, f)
mesh.shutdown_processes()
"""


def _check(results):
    for r in results:
        assert r.returncode == 0, r.stderr[-4000:]


def _spec(s):
    """A JAX PartitionSpec as the port's ``Split`` (None: replicated)."""
    parts = [i for i, a in enumerate(tuple(s)) if a is not None]
    if not parts:
        return None
    return sharding.Split(parts[0], tuple(s)[parts[0]])


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                  for k in path): _spec(s) for path, s in flat}


# ------------------------------------------------------- the JAX references
def _prepare(root, name, mode):
    """The JAX model with non-zero LoRA adapters and one global batch of 4
    rows (each data coordinate's share of them on a grid); the inputs the
    workers need go to ``<name>.pkl``. -> what ``_jax_step`` takes."""
    sub = root / name
    sub.mkdir()
    kw = _kw(sub, index_dtype="int8r", gold_score_mode=mode,
             per_gpu_batch_size=2)
    jopt = jconfig.Options(**kw)
    mesh1 = make_mesh(1, 1, devices=jax.devices()[:1])
    store = JStore.from_jsonl(jopt.passages)
    model, params, _ = jmodel_io.load_or_initialize_model(jopt, store)
    rng = np.random.default_rng(3)
    params["lora"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), params["lora"])
    index = jbuild_index_for(jopt, len(store),
                             model.retriever.cfg.bert.hidden, mesh1)
    model.build_index(index, params)
    ids = (3, 17, 22, 40)
    batch = model.build_batch(mode, index, params,
                              [f"what is the value of e{i}" for i in ids],
                              [f"v{i}" for i in ids])
    batch = {k: np.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    ref = {"kw": kw, "rows": len(ids), "batch": batch, "mode": mode,
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
            jmodes.jsa_loss(model.fns, params, batch, key)
        finally:
            jmodes.mis_chain = orig
        ref["proposals"], ref["uniforms"] = seen["p"], seen["u"]
    with open(root / f"{name}.pkl", "wb") as f:
        pickle.dump(ref, f)
    return jopt, model, params, batch, key, mode


def _jax_step(prep, grid, **flags):
    """One step of the JAX ``make_train_step`` on a ``grid`` mesh under
    ``flags``."""
    jopt, model, params, batch, key, mode = prep
    n_data, n_index = grid
    for k, v in flags.items():
        setattr(jopt, k, v)
    jopt.mesh_data, jopt.mesh_index = n_data, n_index
    mesh_ = make_mesh(n_data, n_index, devices=jax.devices()[:n_data
                                                             * n_index])
    params, specs = jstep.setup_params(jopt, params, mesh_)
    tx, _ = joptim.set_optim(jopt, params)
    state = jstep.init_opt_state(tx, params, specs, mesh_)
    step = jstep.make_train_step(model.fns, mode, tx, mesh_)
    placed = jstep.make_batch_placer(mesh_)(batch)
    params, _, loss, aux = step(params, state, placed, key)
    return {"loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()
                    if not k.startswith("debug/")},
            "specs": _jax_specs(specs),
            "params": _flat(jax.tree_util.tree_map(np.asarray, params))}


def _lm_ref(root):
    cfg = JLMConfig(dtype=jnp.float32, **CFG)
    params = jlm_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    ref = np.asarray(jlm_logits(params, cfg, jnp.asarray(ids),
                                jnp.asarray(mask)))
    with open(root / "lm.pkl", "wb") as f:
        pickle.dump({"cfg": CFG, "ids": ids.astype(np.int64),
                     "mask": mask.astype(np.int64),
                     "params": jax.tree_util.tree_map(np.array, params)}, f)
    return ref


def _ckpt_argv(root):
    sub = root / "ckpt"
    sub.mkdir()
    kw = _kw(sub, index_dtype="float32", per_gpu_batch_size=1,
             total_steps=1, save_freq=1)
    argv = []
    for k, v in kw.items():
        if k in ("log_detail_num",):
            continue
        argv += [f"--{k}", str(v[0] if isinstance(v, list) else v)]
    argv[argv.index("--name") + 1] = "fsdp"
    return argv + ["--device", "cpu", "--shard_optim", "true",
                   "--save_optimizer", "true", "--clip", "1000"]


def _write(root, tag, grid, cases, **extra):
    with open(root / f"{tag}.json", "w") as f:
        json.dump({"grid": list(grid), "cases": cases, **extra}, f)


CASES = {  # name: (mode, grid, flags)
    "fsdp-jsa": ("jsa", (2, 1), {"shard_optim": True}),
    "fsdp-rag": ("rag", (2, 1), {"shard_optim": True}),
    "tp-jsa": ("jsa", (1, 2), {"tensor_parallel": True}),
    "tp-rag": ("rag", (1, 2), {"tensor_parallel": True}),
    "both-rag": ("rag", (2, 2), {"shard_optim": True,
                                 "tensor_parallel": True})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, start the workers, compute the JAX references
    meanwhile; -> (dir, references)."""
    root = tmp_path_factory.mktemp("shard")
    want = {"lm": _lm_ref(root)}
    # one 4-row batch a mode: two rows a data coordinate on (2, 1) and
    # (2, 2), all four on (1, 2)
    preps = {mode: _prepare(root, mode, mode) for mode in ("jsa", "rag")}
    fsdp = {"shard_optim": True}
    _write(root, "pair", (2, 1), [
        {"name": "fsdp-jsa", "ref": "jsa.pkl", "flags": fsdp},
        {"name": "fsdp-rag", "ref": "rag.pkl", "flags": fsdp},
        {"name": "ddp-noclip", "ref": "jsa.pkl",
         "flags": {"clip": 1000.0}},
        {"name": "fsdp-noclip", "ref": "jsa.pkl",
         "flags": {"shard_optim": True, "clip": 1000.0}}],
        lm=True, ckpt=_ckpt_argv(root))
    tp = {"tensor_parallel": True, "mesh_index": 2}
    _write(root, "tp", (1, 2), [
        {"name": "tp-jsa", "ref": "jsa.pkl", "flags": tp},
        {"name": "tp-rag", "ref": "rag.pkl", "flags": tp}], lm=True)
    _write(root, "quad", (2, 2), [
        {"name": "both-rag", "ref": "rag.pkl",
         "flags": {"shard_optim": True, "tensor_parallel": True,
                   "mesh_data": 2, "mesh_index": 2}}])
    t0 = time.monotonic()
    procs = {tag: dryrun.start(WORKER, n, env=ENV, args=(str(root), tag))
             for tag, n in (("pair", 2), ("tp", 2), ("quad", 4))}
    for name, (mode, grid, flags) in CASES.items():
        want[name] = _jax_step(preps[mode], grid, **flags)
    for p in procs.values():
        # each worker's 60 s count from its start
        _check(dryrun.wait(p, TIMEOUT - (time.monotonic() - t0)))
    return root, want


def _load(root, tag, n):
    out = []
    for r in range(n):
        with open(root / f"{tag}_{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ (a)
def test_tp_forward_matches_replicated_and_jax(runs):
    """Two ranks of the index axis: the split forward's logits equal the
    one-process forward's and JAX's within 2e-4; q_w holds 2 of 4 heads."""
    root, want = runs
    for g in _load(root, "tp", 2):
        np.testing.assert_allclose(g["lm"]["one"], want["lm"], atol=2e-4)
        np.testing.assert_allclose(g["lm"]["tp"], g["lm"]["one"], atol=2e-4)
        np.testing.assert_allclose(g["lm"]["tp"], want["lm"], atol=2e-4)
        assert g["lm"]["q_w"] == (32, 16)


def test_fsdp_shards_embed_and_the_moments_follow(runs):
    """FSDP over two ranks splits ``embed`` (128 x 32) by rows, and AdamW
    built on the placement holds a (64, 32) moment for it."""
    root, _ = runs
    for g in _load(root, "pair", 2):
        assert g["lm"]["embed_spec"] == sharding.Split(0, "data")
        assert g["lm"]["embed"] == (64, 32) and g["lm"]["mu"] == (64, 32)


def test_place_dealiases_shared_leaves(runs):
    """Two leaves on one storage (two views, as the storage pointers show
    them) land on storages of their own, equal in value; a split leaf does
    not share its input's storage; one tensor at two paths raises."""
    root, _ = runs
    for r, g in enumerate(_load(root, "pair", 2)):
        assert g["lm"]["distinct"] and g["lm"]["not_input"]
        assert "two paths" in g["lm"]["twice"]
        prior, post, split = g["lm"]["values"]
        assert prior == post == np.ones((16, 8)).tolist()
        assert split == np.arange(32.0).reshape(8, 4)[4 * r:4 * r + 4
                                                      ].tolist()


# ------------------------------------------------------------------ (b)
def _tiny_pair(**over):
    kw = dict(model_size="tiny", max_vocab=300, **over)
    jopt = jconfig.Options(**kw)
    _, jparams, _ = jmodel_io.load_or_initialize_model(
        jopt, JStore.synthetic(4))
    topt = tconfig.Options(device="cpu", **kw)
    tmodel, tparams, _ = tmodel_io.load_or_initialize_model(
        topt, TStore.synthetic(4))
    return jopt, jparams, topt, tmodel, tparams


@pytest.mark.parametrize("case", ["gqa", "gpt2", "kv_heads_undivided"])
@pytest.mark.parametrize("flags", ["shard_optim", "tensor_parallel",
                                   "both"])
def test_spec_trees_match_jax(case, flags):
    """``param_specs`` against the JAX one, leaf for leaf, on the grids
    its flags split: (2, 1), (1, 2) and (2, 2); the kv-heads case on an
    index axis of 4, where 2 kv heads do not divide: JAX splits k_w
    mid-head, the port's ``lm_tp_specs`` equals that, and its placement
    (``whole_heads``) replicates the attention leaves."""
    over = {"generator_model_type": "gpt2"} if case == "gpt2" else {}
    on = {"shard_optim": flags in ("shard_optim", "both"),
          "tensor_parallel": flags in ("tensor_parallel", "both")}
    jopt, jparams, topt, tmodel, tparams = _tiny_pair(**over, **on)
    n_index = (4 if case == "kv_heads_undivided" else 2) \
        if on["tensor_parallel"] else 1
    n_data = 2 if on["shard_optim"] else 1
    grid = mesh.make_grid(n_data, n_index, world=n_data * n_index, rank=0)
    jspecs = _jax_specs(jstep.param_specs(
        jopt, jparams, make_mesh(n_data, n_index,
                                 devices=jax.devices()[:n_data * n_index])))
    raw = tstep.param_specs(topt, tparams, grid)
    assert raw == jspecs
    placed = tstep.param_specs(topt, tparams, grid, tmodel.gen_cfg)
    changed = {p for p in raw if raw[p] != placed[p]}
    if case == "kv_heads_undivided" and on["tensor_parallel"]:
        assert changed == {("generator", "layers", str(i), n)
                           for i in range(2) for n in sharding.ATTENTION}
        assert all(placed[p] is None for p in changed)
    else:
        assert not changed
    assert any(s is not None for s in raw.values())
    if case == "gpt2" and on["tensor_parallel"]:
        # 300 tokens split two ways; gpt2 splits only o_w by rows
        assert raw[("generator", "embed")] == sharding.Split(0, "index")
        assert raw[("generator", "layers", "0", "o_w")] == sharding.Split(
            0, "index")
        assert raw[("generator", "layers", "0", "qkv_w")] is None


def test_whole_heads_and_lm_tp_specs_match_jax_on_the_lm_tree():
    """``lm_tp_specs`` on ``tests/test_sharding.py``'s tree equals JAX's on
    a (1, 2) mesh; with 4 heads over 2 ranks ``whole_heads`` keeps it."""
    params = jlm_init(jax.random.PRNGKey(0), JLMConfig(dtype=jnp.float32,
                                                      **CFG))
    want = _jax_specs(jsharding.lm_tp_specs(
        params, make_mesh(1, 2, devices=jax.devices()[:2]), axis="index"))
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = tstep._flat_specs((), sharding.lm_tp_specs(tree, 2), {})
    assert got == want
    cfg = LMConfig(dtype=torch.float32, **CFG)
    assert tstep._flat_specs((), sharding.whole_heads(
        sharding.lm_tp_specs(tree, 2), cfg, 2), {}) == want


# ------------------------------------------------------------------ (c)
def _assert_step(got, ref, *, params_atol=1e-5):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert set(got["aux"]) == set(ref["aux"])
    for k, v in ref["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    p = _flat(got["params"])
    assert set(p) == set(ref["params"])
    for path, v in ref["params"].items():
        np.testing.assert_allclose(p[path], v, rtol=0, atol=params_atol,
                                   err_msg=str(path))


@pytest.mark.parametrize("mode", ["jsa", "rag"])
def test_fsdp_step_matches_jax(runs, mode):
    """``--shard_optim`` on (2, 1) against the JAX step on a (2, 1) mesh
    under ``shard_optim``; the specs are JAX's; every split leaf and its
    moments hold half the rows on each rank; the ranks end equal."""
    root, want = runs
    ref = want[f"fsdp-{mode}"]
    got = [g[f"fsdp-{mode}"] for g in _load(root, "pair", 2)]
    for g in got:
        _assert_step(g, ref)
        specs = {tuple(k.split("/")): v for k, v in g["specs"].items()}
        assert specs == ref["specs"]
        for k, s in g["specs"].items():
            full = np.shape(_flat(g["params"])[tuple(k.split("/"))])
            if s is not None:
                assert g["shapes"][k][s.dim] * 2 == full[s.dim]
                if k in g["mu"]:
                    assert g["mu"][k] == g["shapes"][k]
    assert got[0]["loss"] == got[1]["loss"]
    for path, v in _flat(got[0]["params"]).items():
        np.testing.assert_array_equal(v, _flat(got[1]["params"])[path])


def test_fsdp_step_is_bit_equal_to_ddp(runs):
    """Where the clip does not trigger, the FSDP step's loss and updated
    params equal the DDP step's bit for bit (a sum of two floats is the
    same in either order); the FSDP rank holds about half the bytes."""
    root, _ = runs
    for g in _load(root, "pair", 2):
        ddp, fsdp = g["ddp-noclip"], g["fsdp-noclip"]
        assert ddp["norm"] < 1000.0 and fsdp["norm"] < 1000.0
        assert fsdp["loss"] == ddp["loss"] and fsdp["aux"] == ddp["aux"]
        a, b = _flat(ddp["params"]), _flat(fsdp["params"])
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], str(path))
        assert fsdp["resident"] < 0.6 * ddp["resident"]


@pytest.mark.parametrize("mode", ["jsa", "rag"])
def test_tensor_parallel_step_matches_jax(runs, mode):
    """``--tensor_parallel`` on (1, 2), LoRA on (non-zero adapters): the
    JAX step on a (1, 2) mesh; the two ranks end with equal trees."""
    root, want = runs
    ref = want[f"tp-{mode}"]
    got = [g[f"tp-{mode}"] for g in _load(root, "tp", 2)]
    for g in got:
        _assert_step(g, ref)
        assert g["specs"]["generator/layers/0/q_w"] == sharding.Split(
            1, "index")
        assert g["shapes"]["generator/layers/0/q_w"] == (64, 32)
    for path, v in _flat(got[0]["params"]).items():
        np.testing.assert_array_equal(v, _flat(got[1]["params"])[path])


def test_four_ranks_with_both_flags_match_jax(runs):
    """One rag step on (2, 2) with ``--shard_optim`` and
    ``--tensor_parallel``: the JAX step on a (2, 2) mesh under both; the
    generator split over index, the rest over data."""
    root, want = runs
    ref = want["both-rag"]
    for g in _load(root, "quad", 4):
        got = g["both-rag"]
        _assert_step(got, ref)
        assert got["specs"]["generator/embed"] == sharding.Split(0, "index")
        assert got["specs"]["retriever/query/embed/word"].axis == "data"


# ------------------------------------------------------------------ (d)
def test_sharded_checkpoint_loads_in_jax_and_resumes_into_the_shards(runs):
    """Two FSDP ranks save through ``main`` with ``--save_optimizer``: the
    JAX package loads the full tree; resumed on two ranks, each rank's
    params and moments are its shards of the saved ones."""
    root, _ = runs
    run = root / "ckpt" / "ck" / "fsdp"
    state = jload_checkpoint(str(run))
    assert state["step"] == 1
    params = _flat(state["params"])
    mu, nu = state["opt_state"]["mu"], state["opt_state"]["nu"]
    for r, g in enumerate(_load(root, "pair", 2)):
        res = g["resume"]
        assert res["step"] == 1 and res["count"] == 1
        assert res["coord"] == [r, 0]
        for k, v in res["params"].items():
            s = res["specs"][k]
            full = params[tuple(k.split("/"))]
            want = full if s is None else np.split(full, 2, axis=s.dim)[r]
            np.testing.assert_array_equal(v, want, err_msg=k)
            for name, got, saved in (("mu", res["mu"], mu),
                                     ("nu", res["nu"], nu)):
                if k in got:
                    m = saved[k]
                    m = m if s is None else np.split(m, 2, axis=s.dim)[r]
                    np.testing.assert_array_equal(got[k], m,
                                                  err_msg=f"{name} {k}")
        assert any(s is not None for s in res["specs"].values())
        assert len(res["mu"]) == len(mu)
