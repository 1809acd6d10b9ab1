"""Sweep the dense scan's runtime geometry on one card (counterpart of
``scripts/analysis/mips_tune.py``).

What the wrappers take at run time is swept: the emit tile ``tile_n``, one
of ``ops/mips_topt.py::KERNEL_TILES`` (128, 256), times the least per-tile
pool ``t_per_tile`` in (2, 4), over a bf16 store of ``n`` seeded unit rows
and bf16 gaussian queries. ``--layout t`` calls ``mips_topk_dense_t`` with
the valid count ``n`` over a store allocated to a multiple of 2048 rows (the
flat index's); ``--layout row`` calls ``mips_topk_dense`` (kernel B6, B3's
instance with every row valid) over the ``n`` rows.

What it does not sweep: the JAX script's ``tile_q`` has no runtime
counterpart, since the query rows of a unit are fixed by the kernel
template (``csrc/wgmma_scan.cuh``), and the pipeline's stages are derived
from the shared memory at compile time. Only the valid pairs are swept, and
a CUDA error propagates.

Timing as ``bench.timed_seconds`` (CUDA events after a warm-up pass on the
card, the host clock with ``--device cpu``)::

    python -m jsa_rag_tpu_torch.analysis.mips_tune [--layout row]
    python -m jsa_rag_tpu_torch.analysis.mips_tune --device cpu --n 4096 \\
        --d 128 --b 8 --k 10 --iters 2

Lines ``tile_n=... t=...  qps (ms/batch)``, ``# best``, and one JSON line
with the device and every configuration.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import bench
from ..device import resolve_device
from ..ops import mips_topt as mt

T_PER_TILE = (2, 4)


def configs() -> list[tuple[int, int]]:
    """Every (tile_n, t_per_tile) pair the kernels take."""
    return [(tn, t) for tn in mt.KERNEL_TILES for t in T_PER_TILE]


def search_fn(layout: str, rows: torch.Tensor, n: int, k: int, tile_n: int,
              t: int):
    if layout == "t":
        return lambda q: mt.mips_topk_dense_t(
            q, rows, k, valid_n=n, pool_n=n, tile_n=tile_n, t_per_tile=t)
    return lambda q: mt.mips_topk_dense(q, rows, k, tile_n=tile_n,
                                        t_per_tile=t)


def store(layout: str, n: int, d: int, seed: int, dev) -> torch.Tensor:
    e = bench.seeded_rows(bench.unit_gaussian(d, dev), n, d, seed, dev)
    if layout == "t":
        return bench.build_index("bfloat16", e).embeddings
    return e.to(torch.bfloat16)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_300_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--layout", choices=("t", "row"), default="t")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {device, geometry, ``configs``: [{tile_n, t_per_tile, T, qps,
    ms}], ``best``}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n, d, b, k = args.n, args.d, args.b, args.k
    rows = store(args.layout, n, d, args.seed, dev)
    rng = np.random.default_rng(args.seed)
    queries = [torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
        for _ in range(max(2, args.iters))]
    print(f"# n={n} d={d} b={b} k={k} iters={len(queries)} "
          f"layout={args.layout}", flush=True)
    out = []
    for tn, t in configs():
        seconds = bench.timed_seconds(
            search_fn(args.layout, rows, n, k, tn, t), queries, dev)
        qps = len(queries) * b / seconds
        row = {"tile_n": tn, "t_per_tile": t,
               "T": mt.scan_geometry(rows.shape[0], min(k, rows.shape[0]),
                                     n, tn, t)[1],
               "qps": qps, "ms": b / qps * 1e3}
        out.append(row)
        print(f"tile_n={tn:5d} t={t}  {qps:9.1f} qps "
              f"({row['ms']:6.2f} ms/batch)", flush=True)
    best = max(out, key=lambda r: r["qps"])
    print(f"# best: {(best['tile_n'], best['t_per_tile'])} -> "
          f"{best['qps']:.1f} qps", flush=True)
    result = {**bench.platform_of(dev), "n": n, "d": d, "b": b, "k": k,
              "layout": args.layout, "configs": out,
              "best": (best["tile_n"], best["t_per_tile"])}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
