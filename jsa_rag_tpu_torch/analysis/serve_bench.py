"""HTTP ``/retrieve`` latency and throughput of the port's server, end to end
(counterpart of ``scripts/analysis/serve_bench.py``).

An in-process ``serve/server.py::IndexServer`` over a flat index of ``--n``
x ``--d`` seeded random unit rows (made on the device) at ``--dtype``, with
``--clients`` concurrent client threads, each posting ``--reqs`` sequential
requests of ``--bsz`` queries at ``--topk``; once with the batcher's 3 ms
coalescing window (the serving default) and once with direct dispatch
(window 0). Everything a client waits for is measured: JSON encode and
decode, the coalescing, the device search, the passage lookup. Per setting:
request p50 and p95 (ms) and queries/s, beside the bare in-process
``index.search`` at one request's batch and at the largest coalesced one
(CUDA events on the card, the host clock on the CPU)::

    python -m jsa_rag_tpu_torch.analysis.serve_bench --n 1300000 --d 1024 \\
        --dtype int8r
    python -m jsa_rag_tpu_torch.analysis.serve_bench --device cpu --n 4096 \\
        --d 64 --reqs 2 --clients 1,4

A check the JAX script does not make: before each setting's sweep one
request of the sweep's queries is served alone, and its passage ids must
equal ``index.search``'s on the same queries at the shapes the server
dispatches (window 0: as sent; with the batcher: rows padded to 8, k to a
power of two, as the batcher pads them, ``serve/server.py::bucket_shape``);
a difference raises. At
``--dtype int8r`` the search is kernel B1, at ``float16`` (refine 4) B4.
Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import numpy as np
import torch

from ..bench import build_index, platform_of, seeded_rows, timed_seconds
from ..bench import unit_gaussian
from ..device import exact_f32_matmul, resolve_device
from ..serve.client import call_retrieve_api
from ..serve.server import IndexServer, bucket_shape
from .synthetic import NumberedPassages

WINDOWS_MS = (3.0, 0.0)
BARE_ITERS = 8  # timed bare searches a batch (the JAX script's reps)


def run_clients(url: str, queries: np.ndarray, n_clients: int,
                reqs: int, topk: int) -> tuple[list, float]:
    """Each of ``n_clients`` threads posts ``reqs`` sequential requests of
    ``queries``; -> (every request's seconds, the wall seconds). A failed
    request is raised after every thread has ended."""
    lat: list[float] = []
    errs: list[Exception] = []
    lock = threading.Lock()

    def worker():
        for _ in range(reqs):
            t0 = time.perf_counter()
            try:
                call_retrieve_api(queries, topk=topk, url=url)
            except Exception as e:  # noqa: BLE001 - re-raised below
                with lock:
                    errs.append(e)
                return
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)

    threads = [threading.Thread(target=worker) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a client thread did not finish in 600 s")
    if errs:
        raise errs[0]
    return lat, wall


def dispatch_shape(rows: int, k: int, window_ms: float) -> tuple[int, int]:
    """(rows, k) of the search the server runs for one request alone."""
    return (rows, k) if window_ms == 0 else bucket_shape(rows, k)


def served_ids_equal(url: str, index, queries: np.ndarray, topk: int,
                     window_ms: float) -> bool:
    """One request served alone against ``index.search`` on the same
    queries at the shape the server dispatches it."""
    docs, _ = call_retrieve_api(queries, topk=topk, url=url)
    got = np.asarray([[int(d["id"]) for d in row] for row in docs])
    rows, k = dispatch_shape(queries.shape[0], topk, window_ms)
    q = np.zeros((rows, queries.shape[1]), np.float32)
    q[:queries.shape[0]] = queries
    _, ids = index.search(q, k)
    want = ids[:queries.shape[0], :topk].cpu().numpy()
    return got.shape == want.shape and bool((got == want).all())


def percentile(sorted_ms: list, p: float) -> float:
    return sorted_ms[min(len(sorted_ms) - 1, int(p * len(sorted_ms)))]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--dtype", default="float16",
                    help="index storage: float16|bfloat16|int8|hybrid|int8r")
    ap.add_argument("--bsz", type=int, default=8, help="queries a request")
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--reqs", type=int, default=12,
                    help="requests a client a setting")
    ap.add_argument("--clients", default="1,8,32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_f32_matmul()
    clients = [int(c) for c in args.clients.split(",")]
    print(f"# {platform_of(dev)} n={args.n} d={args.d} dtype={args.dtype} "
          f"bsz={args.bsz} topk={args.topk}", flush=True)
    e = seeded_rows(unit_gaussian(args.d, dev), args.n, args.d, args.seed,
                    dev)
    index = build_index(args.dtype, e)
    del e
    store = NumberedPassages(args.n)
    rng = np.random.default_rng(args.seed + 1)
    queries = rng.standard_normal((args.bsz, args.d)).astype(np.float32)

    def bare_ms(rows: int) -> float:
        q = torch.from_numpy(rng.standard_normal((rows, args.d)).astype(
            np.float32)).to(dev)
        return timed_seconds(lambda x: index.search(x, args.topk),
                             [q] * BARE_ITERS, dev) * 1e3 / BARE_ITERS

    most = min(1024, max(8, args.bsz * max(clients)))
    bare = {"rows": max(8, args.bsz), "ms": bare_ms(max(8, args.bsz)),
            "rows_max": most, "ms_max": bare_ms(most)}
    print(f"# bare index.search: {bare['ms']:.3f} ms @ B={bare['rows']} | "
          f"{bare['ms_max']:.3f} ms @ B={most}", flush=True)
    print(f"{'window':>8} {'clients':>8} {'p50 ms':>8} {'p95 ms':>8} "
          f"{'qps':>9}", flush=True)
    settings = []
    ids_equal = {}
    for window_ms in WINDOWS_MS:
        server = IndexServer(index, store, args.d, port=0,
                             coalesce_window_s=window_ms / 1e3)
        url = f"http://127.0.0.1:{server.start()}"
        try:
            # every (rows, k) bucket a coalesced dispatch can land in
            rows = 8
            while True:
                r_pad, k_pad = bucket_shape(rows, args.topk)
                index.search(np.zeros((r_pad, args.d), np.float32), k_pad)
                if rows >= args.bsz * max(clients):
                    break
                rows *= 2
            ok = served_ids_equal(url, index, queries, args.topk, window_ms)
            ids_equal[f"{window_ms:g}ms"] = ok
            if not ok:
                raise AssertionError(
                    f"window {window_ms} ms: the served ids differ from "
                    "index.search's on the same queries")
            for c in clients:
                lat, wall = run_clients(url, queries, c, args.reqs,
                                        args.topk)
                ms = sorted(x * 1e3 for x in lat)
                row = {"window_ms": window_ms, "clients": c,
                       "requests": len(ms), "p50_ms": statistics.median(ms),
                       "p95_ms": percentile(ms, 0.95),
                       "qps": len(ms) * args.bsz / wall}
                settings.append(row)
                print(f"{window_ms:>7.1f}m {c:>8d} {row['p50_ms']:>8.1f} "
                      f"{row['p95_ms']:>8.1f} {row['qps']:>9.0f}",
                      flush=True)
        finally:
            server.stop()
    result = {**platform_of(dev), "n": args.n, "d": args.d,
              "dtype": args.dtype, "bsz": args.bsz, "topk": args.topk,
              "reqs": args.reqs, "bare_search": bare,
              "served_ids_equal": ids_equal, "settings": settings}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
