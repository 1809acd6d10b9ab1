"""Port parity of the rank-sharded IVF index: two gloo CPU processes
started with ``torchrun``'s environment contract, against the JAX
``ShardedIVFIndex`` on a (1, 2) virtual CPU mesh in this process. The
workers import torch and the port only, each under a timeout of 60 s.

- the distributed ``lloyd``, each rank holding its half of the rows, from
  the JAX init and split noise: JAX's centroids within 1e-5 and its
  assignments;
- the JAX index's directory loaded two ways (each rank its lists) and
  searched with ragged batches (3 queries on rank 0, 5 on rank 1) at
  n_probe 1, 4 and 16, in dense (f32), sq8 and pq, with and without refine:
  the JAX ids except among ties, the scores within 1e-5;
- the port's own two-rank build (``build_index_for`` over the processes,
  ``set_embeddings`` of every block, ``finalize``): the one-process build's
  centroids within 1e-5 and its ids except among ties; its ``save`` loads
  in the JAX package and in one process, which search alike.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index.ivf import ShardedIVFIndex as JIVF
from jsa_rag_tpu.ops import kmeans as jkmeans
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch.index import build_index_for, load_index
from jsa_rag_tpu_torch.parallel import dryrun

from test_torch_ivf import _jax_init, _near, make_clustered
from test_torch_mips import assert_same_topk

TIMEOUT = 60
ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
D, K, LISTS, ITERS = 64, 10, 16, 5
PROBES = (1, 4, LISTS)
CASES = {  # storage, refine, code size, index dtype, the faiss flag
    "dense": ("dense", False, 32, "float32", None),
    "sq8": ("sq8", False, 32, "bfloat16", "ivfsq"),
    "sq8-refine": ("sq8", True, 32, "bfloat16", "ivfsq"),
    "pq": ("pq", False, 16, "bfloat16", "ivfpq"),
    "pq-refine": ("pq", True, 16, "bfloat16", "ivfpq"),
}
TOL = 1e-5

WORKER = r"""
import json, os, sys
import numpy as np, torch
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch.index import build_index_for, load_index
from jsa_rag_tpu_torch.ops.kmeans import lloyd
from jsa_rag_tpu_torch.parallel import mesh
torch.set_num_threads(1)
root = sys.argv[1]
with open(os.path.join(root, "cfg.json")) as f:
    cfg = json.load(f)
mesh.init_processes("cpu", timeout_s=50)
r = mesh.process_index()
rows = np.load(os.path.join(root, "rows.npy"))
q = np.load(os.path.join(root, "queries.npy"))
mine = q[:3] if r == 0 else q[3:]
out = {}
for name, opt_kw in cfg["cases"].items():
    jidx = load_index(os.path.join(root, "jax-" + name), device="cpu")
    opt = tconfig.Options(device="cpu", **opt_kw)
    idx = build_index_for(opt, len(rows), rows.shape[1], device="cpu")
    for s in range(0, len(rows), 100):
        idx.set_embeddings(s, rows[s:s + 100])
    idx.finalize(iters=cfg["iters"])
    out[name + "/geometry"] = np.array([idx.n_shards, idx.c_local,
                                        idx.list_lo, idx.row_offset,
                                        idx.local_rows])
    out[name + "/centroids"] = idx.centroids.numpy()
    if idx.codebooks is not None:
        out[name + "/codebooks"] = idx.codebooks.numpy()
    for p in cfg["probes"]:
        for tag, index in (("jax", jidx), ("two", idx)):
            s, i = index.search(mine, cfg["k"], n_probe=p)
            out[f"{name}/{tag}/{p}/scores"] = s.numpy()
            out[f"{name}/{tag}/{p}/ids"] = i.numpy()
    idx.save(os.path.join(root, "two-" + name), n_files=3)
lo, n = idx.row_offset, idx.local_rows
init, noise = np.load(os.path.join(root, "init.npy")), np.load(
    os.path.join(root, "noise.npy"))
c, a = lloyd(torch.from_numpy(rows[lo:lo + n]), torch.from_numpy(init),
             iters=cfg["iters"], chunk=96, noise=torch.from_numpy(noise),
             group=torch.distributed.group.WORLD)
out["lloyd/centroids"], out["lloyd/assign"] = c.numpy(), a.numpy()
np.savez(os.path.join(root, f"out_{r}.npz"), **out)
mesh.shutdown_processes()
"""


def _opt_kw(case):
    storage, refine, code, dtype, faiss = CASES[case]
    kw = dict(ivf_n_lists=LISTS, ivf_n_probe=4, index_dtype=dtype,
              ivf_refine=refine, faiss_code_size=code)
    if faiss is None:
        kw["index_mode"] = "ivf"
    else:
        kw.update(index_mode="faiss", faiss_index_type=faiss)
    return kw


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX indexes saved, the workers started, the JAX references and
    the one-process builds computed meanwhile; -> (dir, references)."""
    root = tmp_path_factory.mktemp("ivf2")
    rows = make_clustered(n_clusters=17, per=31, d=D, seed=7)  # 527 rows
    q = _near(rows, 8, seed=11)
    np.save(root / "rows.npy", rows)
    np.save(root / "queries.npy", q)
    key = jax.random.PRNGKey(5)
    init, noise = _jax_init(rows, key, LISTS, ITERS)
    np.save(root / "init.npy", init)
    np.save(root / "noise.npy", noise)
    mesh2 = make_mesh(1, 2, devices=jax.devices()[:2])
    jax_idx = {}
    for name, (storage, refine, code, dtype, _) in CASES.items():
        j = JIVF(mesh2, len(rows), D, dtype=getattr(jnp, dtype),
                 n_lists=LISTS, n_probe=4, storage=storage, code_size=code,
                 refine=refine)
        j.train(jnp.asarray(rows), key=jax.random.PRNGKey(1), iters=ITERS)
        j.save(str(root / f"jax-{name}"), n_files=3)
        jax_idx[name] = j
    with open(root / "cfg.json", "w") as f:
        json.dump({"cases": {c: _opt_kw(c) for c in CASES}, "iters": ITERS,
                   "probes": list(PROBES), "k": K}, f)
    procs = dryrun.start(WORKER, 2, env=ENV, args=(str(root),))
    want = {"lloyd": jkmeans.kmeans(jnp.asarray(rows), key, LISTS,
                                    iters=ITERS, chunk=96)}
    for name, j in jax_idx.items():
        for p in PROBES:
            s, i = j.search(jnp.asarray(q), K, n_probe=p)
            want[f"{name}/{p}"] = (np.asarray(s), np.asarray(i))
        # the port in one process, built as the two ranks build
        opt = tconfig.Options(device="cpu", **_opt_kw(name))
        one = build_index_for(opt, len(rows), D, device="cpu")
        for s in range(0, len(rows), 100):
            one.set_embeddings(s, rows[s:s + 100])
        one.finalize(iters=ITERS)
        want[f"{name}/one"] = one
    _check(dryrun.wait(procs, TIMEOUT))
    return root, want


def _check(results):
    for r in results:
        assert r.returncode == 0, r.stderr[-4000:]


def _got(root):
    return [np.load(root / f"out_{r}.npz") for r in (0, 1)]


def _both(got, key):
    return np.concatenate([g[key] for g in got])


def test_distributed_lloyd_matches_jax_kmeans(runs):
    """Each rank its half of the rows (264 and 263), one all-reduce of the
    sums and counts an iteration: JAX's centroids within 1e-5 on both
    ranks, and its assignments."""
    root, want = runs
    jc, ja = want["lloyd"]
    got = _got(root)
    for g in got:
        np.testing.assert_allclose(g["lloyd/centroids"], np.asarray(jc),
                                   rtol=0, atol=1e-5)
    assert [len(g["lloyd/assign"]) for g in got] == [264, 263]
    np.testing.assert_array_equal(_both(got, "lloyd/assign"),
                                  np.asarray(ja))


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_search_of_jax_lists_matches_jax(runs, case):
    """The JAX directory, each rank holding its 8 of the 16 lists, searched
    with ragged batches at each n_probe: the JAX index's ids except among
    ties and its scores within 1e-5."""
    root, want = runs
    got = _got(root)
    for p in PROBES:
        ts = _both(got, f"{case}/jax/{p}/scores")
        ti = _both(got, f"{case}/jax/{p}/ids")
        js, ji = want[f"{case}/{p}"]
        assert_same_topk(ts, ti, js, ji, tol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_build_matches_one_process(runs, case):
    """The two-rank build (each rank clusters and encodes its rows, the
    rows then travel to their lists' owners) against the one-process build
    from the same seeds: centroids within 1e-5 (codebooks too), and each
    n_probe's ids except among ties."""
    root, want = runs
    one = want[f"{case}/one"]
    got = _got(root)
    for r, g in enumerate(got):
        assert g[f"{case}/geometry"].tolist() == [2, 8, 8 * r, 264 * r,
                                                  264 - r]
        np.testing.assert_allclose(g[f"{case}/centroids"],
                                   one.centroids.numpy(), rtol=0, atol=1e-5)
        if one.codebooks is not None:
            np.testing.assert_allclose(g[f"{case}/codebooks"],
                                       one.codebooks.numpy(), rtol=0,
                                       atol=1e-5)
    q = np.load(root / "queries.npy")
    for p in PROBES:
        s, i = one.search(q, K, n_probe=p)
        assert_same_topk(_both(got, f"{case}/two/{p}/scores"),
                         _both(got, f"{case}/two/{p}/ids"), s.numpy(),
                         i.numpy(), tol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_save_loads_in_jax_and_one_process(runs, case):
    """The two ranks' ``save`` (rank 0 writes the gathered lists): the JAX
    package loads it on one device, the port in one process, and both
    search as the two ranks did."""
    root, _ = runs
    path = str(root / f"two-{case}")
    j = JIVF.load(path, make_mesh(1, 1, devices=jax.devices()[:1]))
    t = load_index(path, device="cpu")
    got = _got(root)
    q = np.load(root / "queries.npy")
    assert (t.n_lists, t.n_shards, t.refine) == (LISTS, 1,
                                                 CASES[case][1])
    for p in PROBES:
        ts = _both(got, f"{case}/two/{p}/scores")
        ti = _both(got, f"{case}/two/{p}/ids")
        js, ji = j.search(jnp.asarray(q), K, n_probe=p)
        os_, oi = t.search(q, K, n_probe=p)
        assert_same_topk(np.asarray(js), np.asarray(ji), ts, ti, tol=TOL)
        assert_same_topk(os_.numpy(), oi.numpy(), ts, ti, tol=TOL)
