"""Port parity: the port's (data, index) grid and its guards against the JAX
package's mesh, in one process (no spawn).

``make_grid``'s checks and messages against ``make_mesh`` on the same
``(n_data, n_index)`` over 1, 2 and 8 devices (the JAX side on
``jax.devices()[:n]`` of the 8 virtual CPU devices of ``conftest.py``; the
port's world size is the device count); the rank -> coordinate map against
the JAX mesh's device array; the global batch of ``host_batch_rows``; the
training entry point's ``--mesh_data`` rule; the ``refine_gather`` check of
``build_index_for``, ``load_index`` and the serve CLI (C5); the A13b guards;
``init_processes``'s refusals. Everything compared is discrete: equal, and
each raise with the JAX package's exact words."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu.index import build_index_for as jbuild_index_for
from jsa_rag_tpu.index import load_index as jload_index
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.train import step as jstep
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch.index import build_index_for, load_index
from jsa_rag_tpu_torch.parallel import mesh
from jsa_rag_tpu_torch.serve.__main__ import main as serve_main
from jsa_rag_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRIDS = [(1, None), (1, 1), (2, None), (1, 2), (2, 1), (3, None), (2, 2),
         (4, None), (2, 4), (8, 1), (1, 8), (4, 2), (8, None), (2, 3),
         (16, None), (3, 1)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("n_data,n_index", GRIDS)
def test_make_grid_matches_make_mesh(n_dev, n_data, n_index):
    """The same grid or the same ``ValueError`` words; a grid's shape is
    the mesh's, and rank r sits where device r sits in the mesh's array."""
    jout = _outcome(lambda: make_mesh(n_data, n_index,
                                      devices=jax.devices()[:n_dev]))
    tout = _outcome(lambda: mesh.make_grid(n_data, n_index, world=n_dev,
                                           rank=0))
    assert tout[0] == jout[0]
    if jout[0] == "ValueError":
        assert tout[1] == jout[1]
        return
    jmesh, grid = jout[1], tout[1]
    assert (grid.n_data, grid.n_index) == jmesh.devices.shape
    assert grid.world == n_dev
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(n_dev):
        g = mesh.make_grid(n_data, n_index, world=n_dev, rank=r)
        assert ids[g.data_rank, g.index_rank] == jax.devices()[r].id
        assert (g.data_rank, g.index_rank) == divmod(r, g.n_index)


def test_one_process_answers_process_0_of_1():
    """Without a process group every helper is the identity."""
    assert not mesh.distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    g = mesh.make_grid()
    assert (g.n_data, g.n_index, g.rank, g.world) == (1, 1, 0, 1)
    t = torch.arange(6.0).reshape(3, 2)
    got, counts = mesh.all_gather_ragged(t)
    assert counts == [3] and torch.equal(got[0], t)
    assert mesh.all_max(7) == 7 and mesh.any_rank(False) is False
    assert mesh.all_sum([1.5, 2.0]) == [1.5, 2.0]
    mesh.barrier()
    assert mesh.init_processes("cpu") == torch.device("cpu")
    assert not mesh.distributed()


@pytest.mark.parametrize("n_data,n_index,per_gpu", [
    (1, 1, 3), (2, 1, 2), (1, 2, 2), (4, 2, 1), (2, 4, 5), (8, 1, 1)])
def test_host_batch_rows_makes_the_jax_global_batch(n_data, n_index,
                                                    per_gpu):
    """Each rank draws ``per_gpu_batch_size`` rows; the grid's data axis
    times that is the JAX package's global batch on the same mesh, and
    ranks that share a data coordinate share their data shard."""
    jmesh = make_mesh(n_data, n_index,
                      devices=jax.devices()[:n_data * n_index])
    jrows = jstep.host_batch_rows(
        jconfig.Options(per_gpu_batch_size=per_gpu), jmesh)
    opt = tconfig.Options(per_gpu_batch_size=per_gpu, device="cpu")
    grids = [mesh.make_grid(n_data, n_index, world=n_data * n_index, rank=r)
             for r in range(n_data * n_index)]
    rows = [tstep.host_batch_rows(opt, g) for g in grids]
    assert set(rows) == {per_gpu}
    assert rows[0] * n_data == jrows
    shards = {g.data_rank for g in grids}
    assert shards == set(range(n_data))


@pytest.mark.parametrize("pc,mesh_data,mesh_index,want", [
    (1, 1, 0, (1, 1)), (2, 1, 0, (2, 1)), (4, 1, 0, (4, 1)),
    (2, 2, 0, (2, 1)), (1, 2, 0, "n_data=2 does not divide device count 1"),
    (2, 3, 0, "--mesh_data 3 must be a multiple of the process count 2"),
    (4, 1, 2, "mesh shape (4, 2) != device count 4"),
    (1, 1, 2, "mesh shape (1, 2) != device count 1")])
def test_training_grid_follows_train_py(monkeypatch, pc, mesh_data,
                                        mesh_index, want):
    """``--mesh_data 1`` under N processes becomes N (``train.py:54-65``);
    a grid that does not match raises the JAX words (C4). The one-process
    rows are held to ``make_mesh`` on one device; the multi-process words
    are ``train.py``'s."""
    monkeypatch.setattr(mesh, "process_count", lambda: pc)
    monkeypatch.setattr(mesh, "process_index", lambda: 0)
    opt = tconfig.Options(mesh_data=mesh_data, mesh_index=mesh_index,
                          device="cpu")
    if isinstance(want, str):
        with pytest.raises(ValueError) as err:
            mesh.training_grid(opt)
        assert str(err.value) == want
        if pc == 1:
            with pytest.raises(ValueError) as jerr:
                make_mesh(mesh_data, mesh_index or None,
                          devices=jax.devices()[:1])
            assert str(jerr.value) == want
    else:
        g = mesh.training_grid(opt)
        assert (g.n_data, g.n_index) == want
    eval_grid = _outcome(lambda: mesh.evaluation_grid(opt))
    jeval = _outcome(lambda: make_mesh(mesh_data, mesh_index or None,
                                       devices=jax.devices()[:pc]))
    assert eval_grid[0] == jeval[0]
    if jeval[0] == "ValueError":
        assert eval_grid[1] == jeval[1]


def _jax_words(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.fixture(scope="module")
def saved_index(tmp_path_factory):
    """A small f32 flat index saved by the JAX package, and its passages."""
    root = tmp_path_factory.mktemp("c5")
    mesh1 = make_mesh(1, 1, devices=jax.devices()[:1])
    rows = np.random.default_rng(0).standard_normal((40, 8)).astype(
        np.float32)
    idx = JaxIndex(mesh1, 40, 8, dtype=jax.numpy.float32)
    idx.set_embeddings(0, rows)
    idx.save(str(root / "index"), n_files=2)
    with open(root / "passages.jsonl", "w") as f:
        for i in range(40):
            f.write(json.dumps({"id": str(i), "title": "t",
                                "text": f"p{i}"}) + "\n")
    return root, mesh1


@pytest.mark.parametrize("value", ["col", "ROWS", ""])
def test_refine_gather_is_checked_with_the_jax_words(saved_index, value):
    """C5: ``build_index_for``, ``load_index`` and the serve CLI raise the
    JAX package's ``ValueError`` for a ``refine_gather`` other than cols or
    rows, with its words; cols and rows still build and load."""
    root, mesh1 = saved_index
    jopt = jconfig.Options(index_dtype="float32", refine_gather=value)
    want = _jax_words(lambda: jbuild_index_for(jopt, 40, 8, mesh1))
    assert want == _jax_words(lambda: jload_index(
        str(root / "index"), mesh1, refine_gather=value))
    topt = tconfig.Options(index_dtype="float32", refine_gather=value,
                           device="cpu")
    assert _jax_words(lambda: build_index_for(topt, 40, 8, "cpu")) == want
    assert _jax_words(lambda: load_index(
        str(root / "index"), device="cpu", refine_gather=value)) == want
    assert _jax_words(lambda: serve_main(
        ["--index_path", str(root / "index"), "--passages",
         str(root / "passages.jsonl"), "--refine_gather", value,
         "--device", "cpu"], block=False)) == want
    for ok in ("cols", "rows"):
        topt.refine_gather = ok
        assert build_index_for(topt, 40, 8, "cpu").n_passages == 40
        assert load_index(str(root / "index"), device="cpu",
                          refine_gather=ok).n_passages == 40


@pytest.mark.parametrize("flag,grid,raises", [
    ("shard_optim", (2, 1), True), ("shard_optim", (1, 2), False),
    ("shard_optim", (1, 1), False), ("tensor_parallel", (1, 2), True),
    ("tensor_parallel", (2, 1), False), ("tensor_parallel", (1, 1), False)])
def test_fsdp_and_tensor_parallel_wait_for_a13b(flag, grid, raises):
    """``--shard_optim`` over a data axis above 1 and ``--tensor_parallel``
    over an index axis above 1 raise ``NotImplementedError`` naming A13b;
    where the axis has size 1 they are the no-op they are in JAX (every
    param spec replicated)."""
    from jsa_rag_tpu.model_io import load_or_initialize_model
    from jsa_rag_tpu.data.passages import PassageStore

    n = grid[0] * grid[1]
    g = mesh.make_grid(*grid, world=n, rank=0)
    topt = tconfig.Options(device="cpu", **{flag: True})
    if raises:
        with pytest.raises(NotImplementedError, match="13b"):
            tstep.param_placement(topt, g)
        return
    assert tstep.param_placement(topt, g) == "replicated"
    jopt = jconfig.Options(model_size="tiny", max_vocab=300, **{flag: True})
    _, params, _ = load_or_initialize_model(jopt, PassageStore.synthetic(4))
    specs = jstep.param_specs(jopt, params,
                              make_mesh(*grid, devices=jax.devices()[:n]))
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert leaves and all(tuple(s) == () for s in leaves)


def test_the_sharded_ivf_index_waits_for_a13b(monkeypatch):
    """An IVF index over several processes raises (its sharded form is
    A13b); the flat index does not."""
    opt = tconfig.Options(index_mode="ivf", index_dtype="float32",
                          device="cpu")
    with pytest.raises(NotImplementedError, match="13b"):
        build_index_for(opt, 64, 8, "cpu",
                        grid=mesh.make_grid(1, 2, world=2, rank=0))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_processes_refuses_what_it_cannot_do(monkeypatch):
    """No fallback hides the device: ``cuda`` without CUDA raises (with or
    without ``torchrun``'s environment); a LOCAL_RANK whose card does not
    exist raises; a failed group join raises (a rank whose rank-0 store
    never answers), in a separate process."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.init_processes("cuda")
    env = dict(WORLD_SIZE="2", RANK="1", LOCAL_RANK="3",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.init_processes("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3"):
        mesh.init_processes("cuda")
    assert not mesh.distributed()
    code = ("import sys\n"
            "from jsa_rag_tpu_torch.parallel import mesh\n"
            "try:\n"
            "    mesh.init_processes('cpu', timeout_s=1)\n"
            "except RuntimeError as err:\n"
            "    print('raised', type(err).__name__)\n"
            "    sys.exit(0)\n"
            "sys.exit(3)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT, **env),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "raised" in out.stdout, out.stderr[-2000:]


def _digest(params) -> list:
    from jsa_rag_tpu_torch.train.optim import named_leaves

    return [(p, t.detach().clone()) for p, t in
            sorted(named_leaves(params).items())]


def test_one_rank_group_run_is_bit_equal_to_no_group(tmp_path, monkeypatch):
    """The training entry point under ``torchrun``'s environment with one
    process (a gloo group here; NCCL on the card): the group, the gradient
    all-reduce and the loss average change no bit of any step's losses or
    of the trained params against the same run without a group."""
    from test_torch_train import _data

    from jsa_rag_tpu_torch.train import __main__ as train_cli

    train, passages = _data(tmp_path)
    argv = ["--device", "cpu", "--model_size", "tiny", "--task", "qa",
            "--gold_score_mode", "jsa", "--index_dtype", "hybrid",
            "--train_data", train, "--passages", passages,
            "--total_steps", "3", "--warmup_steps", "1", "--mis_step", "8",
            "--n_context", "3", "--text_maxlength", "32",
            "--target_maxlength", "16", "--max_vocab", "600",
            "--precision", "fp32", "--log_freq", "1", "--save_freq", "1000",
            "--checkpoint_dir", str(tmp_path / "ck")]
    trained = {}
    real = train_cli.train

    def keep(model, index, params, tx, opt, **kw):
        step = real(model, index, params, tx, opt, **kw)
        trained[opt.name] = (_digest(params), kw["grid"])
        return step

    monkeypatch.setattr(train_cli, "train", keep)
    train_cli.main(argv + ["--name", "plain"])
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    try:
        train_cli.main(argv + ["--name", "group"])
        assert mesh.distributed() and mesh.process_count() == 1
    finally:
        mesh.shutdown_processes()
    assert not mesh.distributed()
    metrics = {}
    for name in ("plain", "group"):
        with open(tmp_path / "ck" / name / "metrics.jsonl") as f:
            metrics[name] = [json.loads(line) for line in f]
    keys = ("loss/train_loss", "loss/generator_loss", "accept_rate")
    assert [[m[k] for k in keys] for m in metrics["group"]] == \
        [[m[k] for k in keys] for m in metrics["plain"]]
    assert all(m["parallel/allreduce_buckets"] == 1 for m in
               metrics["group"])
    assert "parallel/allreduce_ms" not in metrics["plain"][0]
    (plain, g0), (group, g1) = trained["plain"], trained["group"]
    assert (g0.world, g1.world) == (1, 1)
    assert [p for p, _ in plain] == [p for p, _ in group]
    for (p, a), (_, b) in zip(plain, group):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("entry", ["train", "evaluate"])
@pytest.mark.parametrize("flags", [["--mesh_data", "2"],
                                   ["--mesh_index", "4"],
                                   ["--mesh_data", "1", "--mesh_index", "2"]])
def test_mains_refuse_a_grid_the_device_count_refuses(tmp_path, entry,
                                                      flags):
    """C4: the train and evaluate mains build the grid before anything
    else and raise ``make_mesh``'s ``ValueError`` words for one device."""
    from jsa_rag_tpu_torch import evaluate as evaluate_cli
    from jsa_rag_tpu_torch.train import __main__ as train_cli

    main = train_cli.main if entry == "train" else evaluate_cli.main
    opt = jconfig.Options.from_args(flags)
    want = _jax_words(lambda: make_mesh(opt.mesh_data,
                                        opt.mesh_index or None,
                                        devices=jax.devices()[:1]))
    argv = flags + ["--device", "cpu", "--checkpoint_dir",
                    str(tmp_path), "--name", "grid"]
    assert _jax_words(lambda: main(argv)) == want
