"""Same-process arms of the refine and scan frontier on one card
(counterpart of ``scripts/analysis/refine_bench.py``).

The float16 search with ``refine > 0`` is a coarse scan (kernel B4) plus an
f32 rescore of the top-(r*k) candidates (``ops/mips_topt.py::
_f16_refine``), and the int8r search a two-plane int8 scan (B1) plus the
plane-2 rows refine. The refines gather B*r*k rows and materialise them in
f32: a cost that does not show in operation counts. This bench times, over
the same seeded store, each arm through the port's wrappers:

  bf16            ``mips_topk_dense_t`` on a bf16 query (kernel B3, one
                  plane): the max-throughput reference point
  f16_refine      ``mips_topk_f16_t(refine=r)``: B4 + ``_f16_refine``
  f16_refine_rows the same call: the port's fp16 store is already rows
                  (``index/flat.py``), so the arm's line says
                  ``same_as f16_refine`` and it is not timed twice
  f16_exact       ``mips_topk_f16_t(refine=0)``: B5
  rescore_only    ``_f16_refine`` on fixed random (B, r*k) ids: the
                  refine alone, no kernel
  rescore_sorted  the same ids sorted by row within each query
  rescore_rows    ``same_as rescore_only``, as f16_refine_rows
  int8_coarse     ``mips_topk_int8_t(refine=0)``: B2
  int8_hybrid     B2 + ``_f16_refine`` over the fp16 rows
  int8r           ``mips_topk_int8_t(refine=r, res_rows=...)``, the
                  ``int8r_refine="rows"`` default: B1 + the rows refine

Only the stores the chosen arms touch are built: ``n`` seeded unit rows
made on the device a chunk at a time (``bench.seeded_rows``), written
through ``bench.build_index`` (rows allocated to a multiple of 2048 and
searched with the valid count ``n``, as the JAX script pads its stores).
Each arm is timed as ``bench.timed_seconds`` does: a warm-up pass over two
batches, then ``--iters`` batches of ``--b`` numpy gaussian queries, by
CUDA events on the card (the host clock with ``--device cpu``)::

    python -m jsa_rag_tpu_torch.analysis.refine_bench          # 1.3M x 1024
    python -m jsa_rag_tpu_torch.analysis.refine_bench --device cpu \\
        --n 4096 --d 128 --b 8 --k 10 --iters 2

One line an arm (``name ms/call qps``), then one JSON line with the
device and every arm's numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..device import exact_f32_matmul, resolve_device
from ..ops import mips_topt as mt

ARMS = ("bf16", "f16_refine", "f16_refine_rows", "f16_exact",
        "rescore_only", "rescore_sorted", "rescore_rows", "int8_coarse",
        "int8_hybrid", "int8r")
# arms whose JAX counterparts read a second, row-major copy of the fp16
# store: in the port the store is that copy, so the call is the same
SAME_AS = {"f16_refine_rows": "f16_refine", "rescore_rows": "rescore_only"}
# the stores each arm searches
STORES = {"bf16": ("bf16",), "f16_refine": ("f16",),
          "f16_exact": ("f16",), "rescore_only": ("f16",),
          "rescore_sorted": ("f16",), "int8_coarse": ("int8",),
          "int8_hybrid": ("int8", "f16"), "int8r": ("int8r",)}
STORAGE = {"bf16": "bfloat16", "f16": "float16", "int8": "int8",
           "int8r": "int8r"}


def build_stores(names, n: int, d: int, seed: int,
                 dev: torch.device) -> dict:
    """The stores ``names`` (keys of ``STORAGE``) over the same ``n``
    seeded unit rows: ``bf16`` and ``f16`` (n_padded, d) rows, ``int8``
    (codes, (1, n_padded) scales) and ``int8r`` (plane 1, its scales, plane
    2, its scales). int8r's plane 1 is ``quantize_int8`` of the rows, so it
    serves as the int8 store when both are asked for."""
    names = set(names)
    if "int8r" in names:
        names.discard("int8")
    e = bench.seeded_rows(bench.unit_gaussian(d, dev), n, d, seed, dev)
    stores = {}
    for name in sorted(names):
        idx = bench.build_index(STORAGE[name], e)
        if name in ("bf16", "f16"):
            stores[name] = idx.embeddings
        elif name == "int8":
            stores[name] = (idx.embeddings, idx.scales)
        else:
            stores[name] = (idx.embeddings, idx.scales, idx.res,
                            idx.res_scales)
    del e
    if "int8r" in stores:
        stores["int8"] = stores["int8r"][:2]
    return stores


def stores_for(arms) -> set:
    return {s for a in arms for s in STORES.get(SAME_AS.get(a, a), ())}


def methods(stores: dict, n: int, k: int, refine: int,
            ids_fix: torch.Tensor | None = None) -> dict:
    """Arm name -> ``search(q)`` over ``stores`` (``build_stores``), for
    the arms those stores serve; the rescore arms need ``ids_fix`` (B, r*k)
    int32 candidate ids."""
    pool = dict(valid_n=n, pool_n=n)
    out = {}
    if "bf16" in stores:
        rows = stores["bf16"]
        out["bf16"] = lambda q: mt.mips_topk_dense_t(
            q.to(torch.bfloat16), rows, k, valid_n=n)
    if "f16" in stores:
        r16 = stores["f16"]
        out["f16_refine"] = lambda q: mt.mips_topk_f16_t(
            q, r16, k, refine=refine, **pool)
        out["f16_exact"] = lambda q: mt.mips_topk_f16_t(q, r16, k, **pool)
        if ids_fix is not None:
            ids_sort = torch.sort(ids_fix, dim=1).values
            out["rescore_only"] = lambda q: mt._f16_refine(
                q, r16, ids_fix, k, n)
            out["rescore_sorted"] = lambda q: mt._f16_refine(
                q, r16, ids_sort, k, n)
    if "int8" in stores:
        v, s = stores["int8"]
        out["int8_coarse"] = lambda q: mt.mips_topk_int8_t(
            q, v, s, k, refine=0, **pool)
        if "f16" in stores:
            out["int8_hybrid"] = lambda q: mt.mips_topk_int8_t(
                q, v, s, k, refine=refine, f16_rows=stores["f16"], **pool)
    if "int8r" in stores:
        v1, s1, v2, s2 = stores["int8r"]
        out["int8r"] = lambda q: mt.mips_topk_int8_t(
            q, v1, s1, k, refine=refine, res_rows=v2, res_scale=s2, **pool)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_300_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--refine", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--methods", default="",
                    help="comma-separated arms (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {device, geometry, ``stores_s``, ``arms``: {name: {ms, qps} or
    {ms, qps, same_as}}}."""
    args = parse_args(argv)
    want = [a for a in ARMS if not args.methods
            or a in args.methods.split(",")]
    unknown = set(args.methods.split(",")) - set(ARMS) - {""}
    if unknown:
        raise ValueError(f"unknown arms {sorted(unknown)}; of {ARMS}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_f32_matmul()
    n, d, b, k = args.n, args.d, args.b, args.k
    t0 = time.perf_counter()
    stores = build_stores(stores_for(want), n, d, args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stores_s = time.perf_counter() - t0
    print(f"# stores built in {stores_s:.1f}s", flush=True)
    rng = np.random.default_rng(args.seed)
    queries = [torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(dev) for _ in range(max(2, args.iters))]
    ids_fix = torch.from_numpy(rng.integers(
        0, n, (b, args.refine * k)).astype(np.int32)).to(dev)
    table = methods(stores, n, k, args.refine, ids_fix)
    arms = {}
    for name in want:
        other = SAME_AS.get(name)
        if other in arms:
            arms[name] = {**arms[other], "same_as": other}
        else:
            seconds = bench.timed_seconds(table[other or name], queries, dev)
            arms[name] = {"ms": seconds / len(queries) * 1e3,
                          "qps": len(queries) * b / seconds}
            if other:
                arms[name]["same_as"] = other
        row = arms[name]
        print(f"{name:15s} {row['ms']:8.2f} ms/call {row['qps']:9.0f} qps"
              + (f"  (the {row['same_as']} call)" if "same_as" in row
                 else ""), flush=True)
    result = {**bench.platform_of(dev), "n": n, "d": d, "b": b, "k": k,
              "refine": args.refine, "iters": len(queries),
              "stores_s": stores_s, "arms": arms}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
