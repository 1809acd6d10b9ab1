"""Split the int8r search into its layers on one card (counterpart of
``scripts/analysis/int8r_gap_probe.py``).

Between kernel B1 alone and ``ShardedFlatIndex.search`` over an int8r
index lie the wrapper's other layers and the index's. This probe times, in
one process over one seeded store, each of them:

  bf16_ref  ``mips_topk_dense_t`` on a bf16 query over bf16 rows (kernel
            B3): the card's reference point
  kernel    the whole wrapper, ``mips_topk_int8_t(refine=4, res_rows,
            res_scale, int8r_refine="rows")``
  quantize  ``quantize_int8_residual`` of the query batch
  scan      ``scan_topt_int8r2`` on the ready query planes (B1 alone)
  merge     the candidates' permute and reshape, then ``_merge_candidates``
            to the top r*k, on a fixed scan output
  refine    ``_int8r_rows_refine`` on the fixed merge output
  shardmap  the shard program alone: ``ShardedFlatIndex.fused_search_fn``'s
            function on its operands (``index/flat.py``), without the
            query gather
  index     ``ShardedFlatIndex(n, d, "int8r").search(q, k)``

quantize, scan, merge and refine each run on inputs computed once from the
first batch (``split_layers``); their sum is printed beside ``kernel``.
The JAX script's ``kernel_jit`` and ``static`` arms have no counterpart
here: they time an outer XLA ``jit`` and a trace-time constant valid count,
and the port's wrapper is eager with a runtime count. Its ``nomerge`` arm
has none with one process, where the cross-shard merge is of one shard.

Timing as ``bench.timed_seconds``: a warm-up pass over two batches, then
``--iters`` batches of ``--b`` numpy gaussian queries, by CUDA events on
the card (the host clock with ``--device cpu``)::

    python -m jsa_rag_tpu_torch.analysis.int8r_gap_probe    # 1.3M x 1024
    python -m jsa_rag_tpu_torch.analysis.int8r_gap_probe --device cpu \\
        --n 4096 --d 128 --b 8 --k 10 --iters 2

One JSON row an arm (``arm, qps, ms_per_call, n, d, b, k, n_dev`` and the
device), then one with the layers' sum beside ``kernel``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import bench
from ..device import exact_f32_matmul, resolve_device
from ..ops import mips_topt as mt
from ..parallel import mesh

ARMS = ("bf16_ref", "kernel", "quantize", "scan", "merge", "refine",
        "shardmap", "index")
LAYERS = ("quantize", "scan", "merge", "refine")
REFINE = 4


def split_layers(q: torch.Tensor, ops, n: int, k: int,
                 refine: int = REFINE):
    """``mips_topk_int8r_t``'s body cut at its layers, over the int8r
    operands ``ops`` (plane 1, its scales, plane 2, its scales) with valid
    count ``n``: -> ({layer: fn()}, (scores, ids)). Each layer's inputs are
    the previous layer's outputs on ``q``, computed once; the chain's output
    is the wrapper's."""
    v1, s1, v2, s2 = ops
    q = q.to(torch.float32)
    b, n_rows = q.shape[0], v1.shape[0]
    k = min(k, n_rows)
    k_sel = min(refine * k, n_rows)
    tile, t = mt.scan_geometry(n_rows, k_sel, n)
    planes = mt.quantize_int8_residual(q)
    cand = mt.scan_topt_int8r2(*planes, v1, s1, n, tile, t)

    def merge():
        cs, ci = (c.permute(1, 0, 2).reshape(b, -1) for c in cand)
        return mt._merge_candidates(cs, ci, k_sel, b)

    vals, ids = merge()
    layers = {
        "quantize": lambda: mt.quantize_int8_residual(q),
        "scan": lambda: mt.scan_topt_int8r2(*planes, v1, s1, n, tile, t),
        "merge": merge,
        "refine": lambda: mt._int8r_rows_refine(q, vals, v2, s2, ids, k, n),
    }
    return layers, layers["refine"]()


def methods(index, bf16_rows: torch.Tensor | None, q0: torch.Tensor,
            n: int, k: int) -> dict:
    """Arm name -> ``search(q)`` over an int8r ``ShardedFlatIndex`` of
    ``n`` rows and bf16 rows of the same corpus; the layer arms run on
    inputs made once from ``q0``."""
    ops = (index.embeddings, index.scales, index.res, index.res_scales)
    layers, _ = split_layers(q0, ops, n, k)
    fused, fused_ops = index.fused_search_fn(k)
    out = {
        "kernel": lambda q: mt.mips_topk_int8_t(
            q, ops[0], ops[1], k, valid_n=n, pool_n=n, refine=REFINE,
            res_rows=ops[2], res_scale=ops[3], int8r_refine="rows"),
        **{name: (lambda q, fn=fn: fn()) for name, fn in layers.items()},
        "shardmap": lambda q: fused(q, *fused_ops),
        "index": lambda q: index.search(q, k),
    }
    if bf16_rows is not None:
        out["bf16_ref"] = lambda q: mt.mips_topk_dense_t(
            q.to(torch.bfloat16), bf16_rows, k, valid_n=n)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_300_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--arms", default=",".join(ARMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"rows": one dict an arm, "layer_sum_ms", "kernel_ms"}."""
    args = parse_args(argv)
    arms = args.arms.split(",")
    unknown = set(arms) - set(ARMS)
    if unknown:
        raise ValueError(f"unknown arms {sorted(unknown)}; of {ARMS}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_f32_matmul()
    n, d, b, k = args.n, args.d, args.b, args.k
    e = bench.seeded_rows(bench.unit_gaussian(d, dev), n, d, args.seed, dev)
    index = bench.build_index("int8r", e)
    bf16_rows = (bench.build_index("bfloat16", e).embeddings
                 if "bf16_ref" in arms else None)
    del e
    rng = np.random.default_rng(args.seed)
    queries = [torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(dev) for _ in range(max(2, args.iters))]
    table = methods(index, bf16_rows, queries[0], n, k)
    rows, ms = [], {}
    for arm in arms:
        seconds = bench.timed_seconds(table[arm], queries, dev)
        ms[arm] = seconds / len(queries) * 1e3
        row = {"arm": arm, "qps": len(queries) * b / seconds,
               "ms_per_call": ms[arm], "n": n, "d": d, "b": b, "k": k,
               "n_dev": mesh.process_count(), **bench.platform_of(dev)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"rows": rows}
    if set(LAYERS) <= set(ms):
        result["layer_sum_ms"] = sum(ms[a] for a in LAYERS)
        result["kernel_ms"] = ms.get("kernel")
        print(json.dumps({"layers_ms": {a: ms[a] for a in LAYERS},
                          "layer_sum_ms": result["layer_sum_ms"],
                          "kernel_ms": result["kernel_ms"]}), flush=True)
    return result


if __name__ == "__main__":
    main()
