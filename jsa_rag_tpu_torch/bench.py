"""Top-k MIPS throughput on one card, with recall against the exact oracle.

Counterpart of ``bench.py::main`` (:29-266): ``n`` seeded unit-norm gaussian
rows at width ``d`` (the flagship 1,300,000 x 1024: bge-large-en
embeddings, a shard of the 21M-passage corpus) in the store a method
searches, ``iters`` batches of ``b`` gaussian queries (numpy, ``--seed``),
top-``k``. Prints ONE json line: ``platform``, ``metric``, ``value``
(queries/s), ``unit``, the geometry, ``method``, ``recall@100`` of the
method's ids for the first batch against the exact f32 top-k over the
original rows, ``matmul_floor_qps`` (one bare ``torch.matmul`` of the bf16
query against bf16 rows a batch, timed the same way) and ``frac_of_floor``.

    python -m jsa_rag_tpu_torch.bench                   # the Options default
    python -m jsa_rag_tpu_torch.bench --method pallas   # kernel B9
    python -m jsa_rag_tpu_torch.bench --index_dtype int8  # its method, int8t
    python -m jsa_rag_tpu_torch.bench --device cpu --n 4096 --d 64 --b 16

The default method follows ``config.Options`` (``bench.py:88-97``), so the
headline measures the storage users get. Methods, each through the port's
wrapper: ``int8r`` (kernel B1), ``int8r_rows1`` and ``hybrid`` (B2),
``pallas2f16t`` (B4), ``pallas2f16t_exact`` (B5), ``pallas2t`` (B3),
``pallas2`` (B6), ``pallas`` (B9), ``int8t`` (B2 over int8 storage, no
refine: the method of ``--index_dtype int8``, which the JAX bench names but
does not define); ``approx`` raises (ROADMAP queue A item 14). Only the
store the method needs is built, on the device, by the port's flat index
in row chunks (a monolithic quantise of 1.3M x 1024 f32
holds ~11 GB of intermediates), beside bf16 rows for the floor. On the
card the searches are timed with CUDA events after a warm-up; with
``--device cpu`` the plain versions run under the host clock. There is no
fallback: a failure on the card exits non-zero, and no line is printed.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .config import Options
from .device import exact_f32_matmul, resolve_device
from .index.flat import ShardedFlatIndex
from .ops import mips_topt as mt
from .ops.mips import APPROX_NOT_PORTED, mips_topk_exact
from .ops.mips_stream import mips_topk_stream

CHUNK = 65_536  # rows made and stored at a time

# bench.py:91-94: the method that measures each --index_dtype
METHOD_OF_DTYPE = {"int8r": "int8r", "float16": "pallas2f16t",
                   "bfloat16": "pallas2t", "int8": "int8t",
                   "hybrid": "hybrid", "float32": "pallas2t"}


def default_method(opt: Options | None = None) -> str:
    opt = Options() if opt is None else opt
    method = METHOD_OF_DTYPE[opt.index_dtype]
    if method == "int8r" and opt.int8r_refine == "rows1":
        method = "int8r_rows1"
    return method


def seeded_rows(make, n: int, d: int, seed: int, dev: torch.device):
    """(n, d) f32 rows on ``dev``, made ``CHUNK`` at a time by
    ``make(generator, rows)`` from one generator seeded with ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    e = torch.empty((n, d), dtype=torch.float32, device=dev)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        e[lo:hi] = make(g, hi - lo)
    return e


def unit_gaussian(d: int, dev: torch.device):
    def make(g, rows):
        x = torch.randn((rows, d), generator=g, device=dev)
        return x / x.norm(dim=1, keepdim=True)
    return make


def build_index(storage: str, e: torch.Tensor) -> ShardedFlatIndex:
    """A flat index of ``storage`` over f32 rows ``e``, written ``CHUNK``
    rows at a time: the index quantises or casts each block as it stores
    it (int8r's two planes, int8's codes, fp16/bf16 rows; hybrid derives
    its coarse copy at the first search). Rows are allocated to a multiple
    of 2048, as the JAX bench pads its transposed stores."""
    idx = ShardedFlatIndex(e.shape[0], e.shape[1], storage, device=e.device)
    for lo in range(0, e.shape[0], CHUNK):
        idx.set_embeddings(lo, e[lo:lo + CHUNK])
    return idx


def methods(n: int, k: int) -> dict:
    """bench.py:168-198 on the port: method -> (index storage, search(q,
    index)). The ``_t`` methods scan the padded store with the valid count
    n, as the flat index does; ``pallas2`` and ``pallas`` its first n
    rows."""
    pool = dict(valid_n=n, pool_n=n)
    bf16 = torch.bfloat16
    return {
        "int8r": ("int8r", lambda q, x: mt.mips_topk_int8_t(
            q, x.embeddings, x.scales, k, refine=4, res_rows=x.res,
            res_scale=x.res_scales, int8r_refine="rows", **pool)),
        "int8r_rows1": ("int8r", lambda q, x: mt.mips_topk_int8_t(
            q, x.embeddings, x.scales, k, refine=4, res_rows=x.res,
            res_scale=x.res_scales, int8r_refine="rows1", **pool)),
        "pallas2f16t": ("float16", lambda q, x: mt.mips_topk_f16_t(
            q, x.embeddings, k, refine=4, **pool)),
        "pallas2f16t_exact": ("float16", lambda q, x: mt.mips_topk_f16_t(
            q, x.embeddings, k, **pool)),
        "pallas2t": ("bfloat16", lambda q, x: mt.mips_topk_dense_t(
            q.to(bf16), x.embeddings, k, valid_n=n)),
        "pallas2": ("bfloat16", lambda q, x: mt.mips_topk_dense(
            q.to(bf16), x.embeddings[:n], k)),
        "pallas": ("bfloat16", lambda q, x: mips_topk_stream(
            q.to(bf16), x.embeddings[:n], k)),
        "hybrid": ("hybrid", lambda q, x: mt.mips_topk_int8_t(
            q, *x.hybrid_copies(), k, refine=4, f16_rows=x.embeddings,
            **pool)),
        # --index_dtype int8's method (refine 0: the plain int8 search, B2)
        "int8t": ("int8", lambda q, x: mt.mips_topk_int8_t(
            q, x.embeddings, x.scales, k, refine=0, **pool)),
    }


def timed_seconds(search, queries, dev: torch.device) -> float:
    """Seconds for ``search`` over every batch of ``queries`` after a
    warm-up pass over two: CUDA events around the launches on the card, the
    host clock on the CPU."""
    for q in queries[:2]:
        search(q)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for q in queries:
            search(q)
        return time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for q in queries:
        search(q)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def recall_at(ids: torch.Tensor, oracle: torch.Tensor, kk: int) -> float:
    """Mean share of each row's oracle top-``kk`` found in its top-``kk``."""
    return float(np.mean([len(set(a[:kk]) & set(o[:kk])) / kk
                          for a, o in zip(ids.tolist(), oracle.tolist())]))


def platform_of(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "device": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device": "cpu"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_300_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--method", default=None,
                    help="default: the method of --index_dtype")
    ap.add_argument("--index_dtype", default=Options().index_dtype,
                    choices=sorted(METHOD_OF_DTYPE),
                    help="the storage whose method runs when --method is "
                    "not given (default: Options')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    method = args.method or default_method(
        Options(index_dtype=args.index_dtype))
    if method == "approx":
        raise NotImplementedError(APPROX_NOT_PORTED)
    table = methods(args.n, args.k)
    if method not in table:
        raise ValueError(f"unknown bench method {method!r}; one of "
                         f"{sorted(table)} or approx")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_f32_matmul()
    n, d, b, k = args.n, args.d, args.b, args.k
    rng = np.random.default_rng(args.seed)
    queries = [torch.from_numpy(rng.standard_normal((b, d)).astype(
        np.float32)).to(dev) for _ in range(max(2, args.iters))]

    storage, search = table[method]
    e = seeded_rows(unit_gaussian(d, dev), n, d, args.seed, dev)
    kk = min(k, 100)
    _, oracle = mips_topk_exact(queries[0], e, kk)
    index = build_index(storage, e)
    floor_rows = e.to(torch.bfloat16)
    del e
    _, ids = search(queries[0], index)
    recall = recall_at(ids, oracle, kk)
    seconds = timed_seconds(lambda q: search(q, index), queries, dev)
    floor_s = timed_seconds(
        lambda q: torch.matmul(q.to(torch.bfloat16), floor_rows.T), queries,
        dev)
    qps = len(queries) * b / seconds
    floor_qps = len(queries) * b / floor_s
    result = {
        **platform_of(dev),
        "metric": f"mips_top{k}_qps_{n // 1000}k_psgs",
        "value": qps,
        "unit": "queries/s",
        "n": n, "d": d, "b": b, "k": k, "method": method,
        f"recall@{kk}": recall,
        "matmul_floor_qps": floor_qps,
        "frac_of_floor": qps / floor_qps,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
