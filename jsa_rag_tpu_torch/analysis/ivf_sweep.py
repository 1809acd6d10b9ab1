"""Recall against n_probe for every IVF storage, with bytes a vector, search
times and the build split.

Counterpart of ``scripts/analysis/ivf_sweep.py``: a clustered corpus whose
per-dimension variance decays as a power law (``--clusters`` unit centres,
``--noise``, ``--spectrum``; ``storage_recall_bench.clustered_corpus``,
made on the device from ``--seed``), queries that are corpus rows plus
0.05 gaussian noise, the exact f32 top-k over the corpus as oracle; then
for each storage of ``--storages`` (dense bf16: ivfflat; sq8: ivfsq; pq:
ivfpq of ``--code_size`` bytes; ``+refine``: the fp16 copy and its f32
rescore) an IVF index of ``--n_lists`` lists (0: ``auto_n_lists``), its
build seconds by stage, its stored bytes, and at each ``--n_probes``
recall@k and the search time at B = 8 and 64. Prints one JSON row per
storage and n_probe.

    python -m jsa_rag_tpu_torch.analysis.ivf_sweep            # the card
    python -m jsa_rag_tpu_torch.analysis.ivf_sweep --device cpu \\
        --n 20000 --d 64 --code_size 16 --n_probes 1,4,16

Recall is measured in batches of ``--recall_batch`` queries (8): an IVF
search scores each query against the union of the lists its batch probes,
so a larger batch reads a higher recall at the same n_probe (the JAX
script searches all its queries in one batch: ``--recall_batch`` equal to
``--queries`` repeats that). Search times are the host clock per call,
synchronised: the search reads its list union on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..bench import platform_of, recall_at
from ..device import exact_f32_matmul, resolve_device
from ..index.ivf import ShardedIVFIndex, auto_n_lists
from ..ops.mips import mips_topk_exact
from .storage_recall_bench import clustered_corpus

STORAGES = {"dense": ("dense", False), "sq8": ("sq8", False),
            "sq8+refine": ("sq8", True), "pq": ("pq", False),
            "pq+refine": ("pq", True)}
TIMED_BATCHES = (8, 64)


def bytes_per_vec(storage: str, refine: bool, d: int, code_size: int) -> int:
    """Bytes a row costs in the lists (bf16 dense, int8 + f32 scale, or
    ``code_size`` codes), plus the fp16 refine copy."""
    return ({"dense": 2 * d, "sq8": d + 4, "pq": code_size}[storage]
            + (2 * d if refine else 0))


def stored_bytes(idx: ShardedIVFIndex) -> int:
    """Device bytes of every array the index keeps (the packed lists)."""
    return sum(t.numel() * t.element_size() for t in (
        idx.centroids, idx.row_list, idx.list_rows, idx.list_ids,
        idx.list_scales, idx.codebooks, idx.pq_rotation, idx.list_rows_f16)
        if t is not None)


def padded_bytes(idx: ShardedIVFIndex) -> int:
    """Bytes of the (C, cap) lists the JAX package keeps in memory and
    both packages write to disk: rows, ids (and scales, fp16 copy)."""
    per_row = (idx.list_rows.shape[1] * idx.list_rows.element_size() + 4
               + (4 if idx.list_scales is not None else 0)
               + (2 * idx.dim if idx.refine else 0))
    return idx.n_lists * idx.cap * per_row


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(name: str, e: torch.Tensor, n_lists: int, code_size: int,
          seed: int) -> ShardedIVFIndex:
    """An IVF index of storage ``name`` over rows ``e``; ``build_s`` holds
    its stages' seconds and their total."""
    storage, refine = STORAGES[name]
    idx = ShardedIVFIndex(e.shape[0], e.shape[1], "bfloat16",
                          device=e.device, n_lists=n_lists, storage=storage,
                          code_size=code_size, refine=refine)
    _sync(e.device)
    t0 = time.perf_counter()
    idx.train(e, generator=torch.Generator(device=e.device).manual_seed(
        seed))
    _sync(e.device)
    idx.build_s["total"] = time.perf_counter() - t0
    return idx


def sweep_queries(e: torch.Tensor, n: int, seed: int) -> torch.Tensor:
    """(n, d) queries: random rows of ``e`` plus 0.05 gaussian noise a
    coordinate (``scripts/analysis/ivf_sweep.py``'s queries)."""
    g = torch.Generator(device=e.device).manual_seed(seed)
    pick = torch.randint(0, e.shape[0], (n,), generator=g, device=e.device)
    return e[pick] + 0.05 * torch.randn((n, e.shape[1]), generator=g,
                                        device=e.device)


def hits_at(ids: torch.Tensor, oracle: torch.Tensor, k: int) -> int:
    """How many of the oracle's top-k ids each row's top-k holds, summed
    (recall@k times rows times k, as an integer)."""
    return sum(len(set(a[:k]) & set(o[:k]))
               for a, o in zip(ids.tolist(), oracle.tolist()))


def batched_ids(idx, q: torch.Tensor, k: int, n_probe: int,
                batch: int) -> torch.Tensor:
    return torch.cat([idx.search(q[i:i + batch], k, n_probe=n_probe)[1]
                      for i in range(0, q.shape[0], batch)])


def search_ms(idx, q: torch.Tensor, k: int, n_probe: int,
              iters: int) -> float:
    """Host milliseconds per search call of the batch ``q``, synchronised,
    after two warm-up calls."""
    for _ in range(2):
        idx.search(q, k, n_probe=n_probe)
    _sync(q.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        idx.search(q, k, n_probe=n_probe)
    _sync(q.device)
    return (time.perf_counter() - t0) * 1e3 / iters


def measure(idx, name: str, q: torch.Tensor, oracle: torch.Tensor, k: int,
            n_probes, code_size: int, recall_batch: int = 8,
            iters: int = 5, time_search: bool = True) -> list[dict]:
    """One row per n_probe: recall@k against ``oracle`` (batches of
    ``recall_batch``) and, with ``time_search``, ms a search at B = 8 and
    64."""
    storage, refine = STORAGES[name]
    rows = []
    for n_probe in n_probes:
        n_probe = min(n_probe, idx.n_lists)
        ids = batched_ids(idx, q, k, n_probe, recall_batch)
        row = {"storage": name, "n_probe": n_probe,
               "n_lists": idx.n_lists, "cap": idx.cap,
               f"recall@{k}": recall_at(ids.cpu(), oracle.cpu(), k),
               "hits": hits_at(ids, oracle, k),
               "unfilled": int((ids < 0).sum()),
               "bytes_per_vec": bytes_per_vec(storage, refine, idx.dim,
                                              code_size),
               "stored_bytes": stored_bytes(idx),
               "padded_bytes": padded_bytes(idx),
               "largest_list": max(b - a for a, b in zip(idx.offsets,
                                                         idx.offsets[1:])),
               "build_s": dict(idx.build_s)}
        if time_search:
            row["search_ms"] = {b: search_ms(idx, q[:b], k, n_probe, iters)
                                for b in TIMED_BATCHES}
        rows.append(row)
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--code_size", type=int, default=32)
    ap.add_argument("--n_lists", type=int, default=0)
    ap.add_argument("--n_probes", default="1,4,16,64,256")
    ap.add_argument("--storages", default=",".join(STORAGES))
    ap.add_argument("--noise", type=float, default=0.25)
    ap.add_argument("--spectrum", type=float, default=0.5)
    ap.add_argument("--recall_batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    names = args.storages.split(",")
    unknown = [s for s in names if s not in STORAGES]
    if unknown:
        raise ValueError(f"unknown storages {unknown}; one of "
                         f"{sorted(STORAGES)}")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        exact_f32_matmul()
    e = clustered_corpus(args, dev)
    q = sweep_queries(e, args.queries, args.seed + 2)
    _, oracle = mips_topk_exact(q, e, args.k)
    n_lists = args.n_lists or auto_n_lists(args.n)
    n_probes = [int(p) for p in args.n_probes.split(",")]
    results = []
    for name in names:
        idx = build(name, e, n_lists, args.code_size, args.seed)
        for row in measure(idx, name, q, oracle, args.k, n_probes,
                           args.code_size, args.recall_batch, args.iters,
                           time_search=dev.type == "cuda"):
            row.update(n=args.n, d=args.d, **platform_of(dev))
            results.append(row)
            print(json.dumps(row), flush=True)
        del idx
    return results


if __name__ == "__main__":
    main()
