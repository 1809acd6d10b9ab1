"""Recall and throughput of every index storage at flagship geometry.

Counterpart of ``scripts/analysis/storage_recall_bench.py``: a clustered
corpus whose per-dimension variance decays as a power law (``--clusters``
centres, ``--noise``, ``--spectrum``; unit rows, as real sentence-encoder
embeddings concentrate their energy in a few hundred directions), queries
that are perturbed corpus rows, the exact f32 top-k of the queries over the
corpus as oracle, then for each mode of ``--modes`` its store, recall@20
and recall@100 against the oracle, and queries/s over ``--iters`` searches
of the batch. Prints one JSON row per mode.

    python -m jsa_rag_tpu_torch.analysis.storage_recall_bench
    python -m jsa_rag_tpu_torch.analysis.storage_recall_bench \\
        --modes bf16_row,f16_row,int8
    python -m jsa_rag_tpu_torch.analysis.storage_recall_bench --device cpu \\
        --n 20000 --d 256 --b 32

Everything is made on the device from ``--seed``, in row chunks; the f32
corpus stays there while each mode's store is built from it by the port's
flat index (5.3 GB at 1.3M x 1024). The port's stores are row-major, so
the ``_t`` and row modes of one dtype reach different wrappers over one
layout (a ``_t`` wrapper takes the valid count and pool bound a flat index
passes, a row wrapper the first n rows): bf16_t B3, bf16_row B6, f16_t B5,
f16_row B7, f16_refine B4, int8_t and hybrid B2, int8 B8, int8r B1; the
``flat_*_index`` modes call the index's own search. The names are the TPU
sweep's, so its rows line up. Timing as in ``jsa_rag_tpu_torch.bench``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..bench import (build_index, methods, platform_of, recall_at,
                     seeded_rows, timed_seconds)
from ..device import exact_f32_matmul, resolve_device
from ..ops import mips_topt as mt
from ..ops.mips import mips_topk_exact

BYTES_PER_ELEMENT = {"bf16_t": 2, "f16_t": 2, "f16_row": 2, "bf16_row": 2,
                     "int8": 1, "int8_t": 1, "flat_int8_index": 1,
                     "f16_refine": 2, "flat_f16_index": 2,
                     "flat_bf16_index": 2, "hybrid": 3,
                     "flat_hybrid_index": 3, "int8r": 2,
                     "flat_int8r_index": 2}


def modes(n: int, k: int) -> dict:
    """storage_recall_bench.py:143-193 on the port: mode -> (index storage,
    search(q, index)); a mode that searches as a bench method does is that
    method's entry of ``jsa_rag_tpu_torch.bench.methods``."""
    bench = methods(n, k)
    pool = dict(valid_n=n, pool_n=n)

    def flat(q, x):
        return x.search(q, k)

    return {
        "bf16_t": ("bfloat16", lambda q, x: mt.mips_topk_dense_t(
            q.to(torch.bfloat16), x.embeddings, k, **pool)),
        "f16_t": bench["pallas2f16t_exact"],
        "f16_refine": bench["pallas2f16t"],
        "f16_row": ("float16", lambda q, x: mt.mips_topk_f16(
            q, x.embeddings[:n], k)),
        "bf16_row": bench["pallas2"],
        "int8": ("int8", lambda q, x: mt.mips_topk_int8(
            q, x.embeddings[:n], x.scales[:, :n].reshape(-1, 1), k)),
        "int8_t": ("int8", lambda q, x: mt.mips_topk_int8_t(
            q, x.embeddings, x.scales, k, **pool)),
        "flat_int8_index": ("int8", flat),
        "hybrid": bench["hybrid"],
        "flat_hybrid_index": ("hybrid", flat),
        "int8r": bench["int8r"],
        "flat_int8r_index": ("int8r", flat),
        "flat_f16_index": ("float16", flat),
        "flat_bf16_index": ("bfloat16", flat),
    }


def clustered_corpus(args, dev: torch.device) -> torch.Tensor:
    """(n, d) unit rows: ``clusters`` power-law-weighted unit centres, each
    row a random centre plus ``noise`` times weighted gaussian noise
    (storage_recall_bench.py:67-77), made in row chunks."""
    d = args.d
    w = (torch.arange(d, dtype=torch.float32, device=dev) + 1.0) \
        ** -args.spectrum
    g = torch.Generator(device=dev).manual_seed(args.seed)
    centers = torch.randn((args.clusters, d), generator=g, device=dev) * w
    centers /= centers.norm(dim=1, keepdim=True)

    def make(gen, rows):
        assign = torch.randint(0, args.clusters, (rows,), generator=gen,
                               device=dev)
        x = centers[assign] + args.noise * w * torch.randn(
            (rows, d), generator=gen, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    return seeded_rows(make, args.n, d, args.seed + 1, dev)


def perturbed_queries(e: torch.Tensor, b: int, seed: int) -> torch.Tensor:
    """(b, d) unit queries: random corpus rows plus 0.3 gaussian noise
    (storage_recall_bench.py:79-86), so near neighbours exist."""
    g = torch.Generator(device=e.device).manual_seed(seed)
    rows = torch.randint(0, e.shape[0], (b,), generator=g, device=e.device)
    q = e[rows] + 0.3 * torch.randn((b, e.shape[1]), generator=g,
                                    device=e.device)
    return q / q.norm(dim=1, keepdim=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_300_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--b", type=int, default=512)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=4096)
    ap.add_argument("--noise", type=float, default=0.25)
    ap.add_argument("--spectrum", type=float, default=0.5)
    ap.add_argument("--modes", default="bf16_t,f16_t,f16_row,int8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    table = modes(args.n, args.k)
    names = args.modes.split(",")
    unknown = [m for m in names if m not in table]
    if unknown:
        raise ValueError(f"unknown modes {unknown}; one of {sorted(table)}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_f32_matmul()
    e = clustered_corpus(args, dev)
    q = perturbed_queries(e, args.b, args.seed + 2)
    _, oracle = mips_topk_exact(q, e, args.k)
    results = []
    for mode in names:
        storage, search = table[mode]
        index = build_index(storage, e)
        _, ids = search(q, index)
        seconds = timed_seconds(lambda x: search(x, index),
                                [q] * args.iters, dev)
        row = {"mode": mode, "recall@20": recall_at(ids, oracle, 20),
               "recall@100": recall_at(ids, oracle, min(args.k, 100)),
               "qps": args.iters * args.b / seconds,
               "hbm_gb": args.n * args.d * BYTES_PER_ELEMENT[mode] / 2 ** 30,
               "n": args.n, "d": args.d, "b": args.b, "k": args.k,
               **platform_of(dev)}
        results.append(row)
        print(json.dumps(row), flush=True)
        del index
    return results


if __name__ == "__main__":
    main()
