"""A closed loop of top-k searches over the configuration's flat index, one
batch in flight: each batch a (B, d) block of unit query embeddings from a
pool made on the card at set-up and cycled, sent to
``ShardedFlatIndex.search(q, k)``, its scores and ids copied to the host.

Traffic parameters: ``batch``, ``k``, ``pool_batches``, ``warmup_batches``,
``sample_batches`` (the answers judged, drawn from the seed over the whole
window), ``trace_after_s`` and ``trace_batches`` (the profiled stretch of a
traced run).

End-to-end: ``search_qps`` (queries answered over the window's seconds) and
``search_p95_ms`` (95th percentile of every batch's time from dispatch to
its ids and scores on the host). The judged answers are compared with an
exact float32 search over the original rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..harness import Window, checks_against
from ..reference import search as ref_search
from ..reference.precision import exact_f32
from ..yardstick import flops
from ..yardstick.trace import Capture, span
from .common import Reservoir, filled_index, sync


def query_pool(ctx) -> torch.Tensor:
    """The (pool_batches, batch, d) unit query embeddings, made from the
    seed on the run's device."""
    t = ctx.traffic
    b, d = int(t["batch"]), int(ctx.config["index"]["dim"])
    n = int(t["pool_batches"])
    return inputs.unit_queries(inputs.derive_seed(ctx.seed, "queries"),
                               n * b, d, ctx.device).reshape(n, b, d)


def setup(ctx):
    t, dev = ctx.traffic, ctx.device
    index = filled_index(ctx.config["index"], ctx.seed, dev)
    pool = query_pool(ctx)
    for i in range(int(t["warmup_batches"])):
        s, ids = index.search(pool[i % len(pool)], int(t["k"]))
        s.cpu(), ids.cpu()
    sync(dev)
    return {"ctx": ctx, "index": index, "pool": pool}


def window(state, seconds: float, trace: bool) -> Window:
    ctx, index, pool = state["ctx"], state["index"], state["pool"]
    t, dev = ctx.traffic, ctx.device
    k, b = int(t["k"]), int(t["batch"])
    sample = Reservoir(int(t["sample_batches"]),
                       inputs.derive_seed(ctx.seed, "sample"))
    cap = Capture(dev.type) if trace else None
    traced, stopped = None, False
    lat = []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if cap is not None and traced is None and \
                time.perf_counter() - t0 >= float(t["trace_after_s"]):
            sync(dev)
            cap.start()
            traced = i
        a = time.perf_counter()
        with span("search.batch"):
            s, ids = index.search(pool[i % len(pool)], k)
            s_h, i_h = s.cpu().numpy(), ids.cpu().numpy()
        e = time.perf_counter()
        lat.append(e - a)
        slot = sample.wants()
        if slot is not None:
            sample.put(slot, (i % len(pool), s_h, i_h))
        i += 1
        if traced is not None and not stopped and \
                i - traced >= int(t["trace_batches"]):
            sync(dev)
            cap.stop()
            stopped = True
        paused = cap.pause_s if cap else 0.0
        if e - paused >= deadline and (cap is None or stopped):
            break
    elapsed = e - t0 - paused
    state["sample"] = sample.items
    lat_ms = np.asarray(lat) * 1e3
    n, d = int(ctx.config["index"]["rows"]), int(ctx.config["index"]["dim"])
    ops = flops.int8r_search_ops(b, n, d, k, index.refine_r)
    n_bytes = flops.int8r_search_bytes(b, n, d, k, index.refine_r)
    b1_ops, b1_bytes = flops.b1_scan_work(b, n, d, int(t["tile_n"]),
                                          int(t["t_per_tile"]))
    return Window(
        e2e={"search_qps": i * b / elapsed,
             "search_p95_ms": float(np.percentile(lat_ms, 95))},
        attempted=i * b, failed=0, window_s=elapsed,
        spans={"search.batch_ms": lat_ms.tolist()},
        work={"int8": ops["int8"] * i, "f32": ops["f32"] * i,
              "bytes": n_bytes * i},
        counters={"b1_ops_per_launch": b1_ops,
                  "b1_bytes_per_launch": b1_bytes},
        trace=cap.trace() if cap else None)


def outputs(state) -> dict:
    return {"sample": state["sample"]}


def release(state) -> None:
    state.clear()


def check(ctx, outs) -> list:
    return checks_against(ctx.limits, compare(ctx, outs["sample"]))


def compare(ctx, sample) -> dict:
    """The judged answers against an exact float32 search over the
    original rows: ``score_err`` (largest gap between an answer's score and
    its row's exact score), ``rank_gap`` (how far the r-th answer's exact
    score lies below the exact r-th score, at worst), ``recall`` (share of
    the exact top k answered, the mean over queries) and ``bad_ids`` (ids
    outside the corpus or repeated within a row)."""
    t, c, dev = ctx.traffic, ctx.config, ctx.device
    exact_f32()
    n, d = int(c["index"]["rows"]), int(c["index"]["dim"])
    k = int(t["k"])
    pool = query_pool(ctx)
    q = torch.cat([pool[slot] for slot, _, _ in sample])
    got_s = torch.as_tensor(np.concatenate([s for _, s, _ in sample]),
                            device=dev, dtype=torch.float32)
    got_i = torch.as_tensor(np.concatenate([i for _, _, i in sample]),
                            device=dev, dtype=torch.long)
    bad = (got_i < 0) | (got_i >= n)
    srt = torch.sort(got_i, dim=1).values
    dup = int((srt[:, 1:] == srt[:, :-1]).sum())
    rows = inputs.unit_rows(inputs.derive_seed(ctx.seed, "rows"), n, d, dev)
    top_s, top_i, probe = ref_search.scan(q, rows, k,
                                          probe=got_i.clamp(0, n - 1))
    probe = torch.where(bad, float("-inf"), probe)
    hit = (got_i[:, :, None] == top_i[:, None, :]).any(dim=2)
    return {
        "score_err": float((got_s - probe).abs().max()),
        "rank_gap": float((top_s - probe).max()),
        "recall": float(hit.float().sum(dim=1).mean() / k),
        "bad_ids": float(int(bad.sum()) + dup),
    }
