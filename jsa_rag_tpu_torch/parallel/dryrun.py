"""One data-parallel training step over N CPU processes on gloo, at a tiny
size (the counterpart of ``__graft_entry__.py::dryrun_multichip``, :64):

    python -m jsa_rag_tpu_torch.parallel.dryrun --nproc 2

The launcher starts N workers with ``torchrun``'s environment contract
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``
on a free localhost port). Each joins the group (``init_processes("cpu")``),
builds the tiny jsa model from the same seed, an f32 flat index sharded over
the ranks and filled by the passage tower (each rank embeds its shard),
draws its own rows of the global batch, takes one step through the
production ``make_train_step`` (the gradient all-reduce), re-embeds the
index with the updated tower and searches it again, and checks that the
replicas hold equal params. Rank 0 prints one JSON line; a failure on any
rank exits non-zero. Every worker runs under ``--timeout`` seconds, so a
desync fails instead of hanging.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(code: str, nproc: int, env: dict | None = None,
          cwd: str = ROOT, args: tuple = ()) -> list:
    """Start ``python -c code *args`` in ``nproc`` processes with the
    ``torchrun`` environment on a free localhost port; -> the Popen
    objects (stdout and stderr piped)."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        e = dict(os.environ, **(env or {}), RANK=str(rank),
                 WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 PYTHONPATH=cwd)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, *args], cwd=cwd, env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait(procs: list, timeout: float) -> list:
    """Wait for ``start``'s processes; -> their CompletedProcess objects.
    A process still running ``timeout`` seconds from now is killed, and so
    are the others (a desync fails instead of hanging)."""
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            try:
                so, se = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                so, se = p.communicate()
                se += f"\nkilled after {timeout} s"
            out.append(subprocess.CompletedProcess(
                p.args, p.returncode if p.returncode is not None else -9,
                so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def launch(code: str, nproc: int, timeout: float, env: dict | None = None,
           cwd: str = ROOT, args: tuple = ()) -> list:
    """``start`` then ``wait``."""
    return wait(start(code, nproc, env, cwd, args), timeout)


def worker() -> dict:
    """One rank's step (run under the launcher's environment)."""
    import numpy as np
    import torch

    from ..config import Options
    from ..data.passages import PassageStore
    from ..index import build_index_for
    from ..model_io import load_or_initialize_model
    from ..train.modes import StepRng
    from ..train.optim import set_optim
    from ..train.step import host_batch_rows, make_train_step, sync_params
    from . import mesh

    dev = mesh.init_processes("cpu")
    grid = mesh.training_grid(Options(device="cpu"))
    opt = Options(model_size="tiny", precision="fp32", use_lora=False,
                  gold_score_mode="jsa", n_context=4, mis_step=8,
                  text_maxlength=96, target_maxlength=12,
                  per_gpu_batch_size=2, temperature_gold=1.0,
                  temperature_score=1.0, index_dtype="float32", dropout=0.0,
                  device=str(dev), mesh_data=grid.n_data)
    store = PassageStore.synthetic(16 * grid.world, seed=0)
    model, params, _ = load_or_initialize_model(opt, store)
    tx = set_optim(opt, params)
    sync_params(tx.leaves)
    index = build_index_for(opt, len(store), model.retriever.cfg.bert.hidden,
                            device=dev, grid=grid)
    model.build_index(index, params)
    rows = host_batch_rows(opt, grid)
    lo = grid.data_rank * rows
    queries = [f"what is w{i} about" for i in range(lo, lo + rows)]
    targets = [f"w{i + 3}" for i in range(lo, lo + rows)]
    batch = model.build_batch("jsa", index, params, queries, targets)
    step = make_train_step(model, "jsa", tx)
    loss, _ = step(params, batch, StepRng.from_seed(grid.rank, dev))
    loss = float(loss)
    assert np.isfinite(loss), loss
    model.build_index(index, params)  # the refresh with the new tower
    _, ids = index.search(model.embed_queries(params, queries), 4)
    assert tuple(ids.shape) == (rows, 4) and int(ids.min()) >= 0
    sums = mesh.all_gather(torch.stack([t.detach().double().sum()
                                        for t in tx.leaves]))
    equal = bool((sums == sums[0]).all())
    assert equal, "replicas differ after the step"
    return {"world": grid.world, "grid": [grid.n_data, grid.n_index],
            "loss": loss, "buckets": step.reducer.buckets,
            "shard_rows": index.shard_rows, "replicas_equal": equal}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)
    code = ("import json\n"
            "from jsa_rag_tpu_torch.parallel import dryrun, mesh\n"
            "out = dryrun.worker()\n"
            "if mesh.process_index() == 0:\n"
            "    print(json.dumps(out), flush=True)\n"
            "mesh.shutdown_processes()\n")
    results = launch(code, args.nproc, args.timeout)
    for r in results:
        if r.returncode != 0:
            sys.stderr.write(r.stderr)
            return 1
    line = results[0].stdout.strip().splitlines()[-1]
    print(line)
    return 0 if json.loads(line)["replicas_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
