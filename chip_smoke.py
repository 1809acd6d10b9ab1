#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: one CUDA card, the index-serving path and
the evaluate path at full width, every kernel of those paths against its
plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure ends the run with a non-zero exit and no result line):

1. environment — the card's name and power limit, CUDA present, TF32 off;
2. build — ``nvcc`` builds every kernel (B1 ``topt_int8r2``, B3
   ``topt_dense``) from ``csrc/``, one process per source, concurrently;
3. B1 against its plain version on the card, at the index-tile shapes the
   serve path gives it (d=1024, N=262,144 with 777 padded rows, B=64, 400
   candidates; and B=5, N=4099 with more candidates than valid rows);
4. serve at full width — bge-large-geometry towers (24 x 1024, cls_norm,
   vocab 30522; seeded random init, no checkpoint is in the repository), an
   int8r index of 1,300,000 x 1024 whose first 16,384 rows the passage
   tower builds from ``PassageStore.synthetic`` texts and whose rest is a
   seeded clustered corpus made on the card; saved, then served by
   ``python -m jsa_rag_tpu_torch.serve``'s ``main``; concurrent
   ``/retrieve`` requests at topk 100 (query-tower embeddings of corpus
   texts, near-duplicate rows, perturbed rows); gold top-1, recall@100
   against the chunked exact-f32 oracle over the original float rows, B1's
   launches during this phase, p50 request latency;
5. on the served index: B1 against its plain version at every row bucket
   the batcher dispatched in phase 4 (and 32, 64), then timed at the serve
   path's shapes beside its plain version, one PyTorch library call for the
   same products, and its bound;
6. B3 against its plain version on the card: bf16 unit rows, B=64,
   N=262,144 with 777 padded rows, d=1024, 400 candidates; f32, B=5,
   N=4,099 with 3,000 valid, d=256, more candidates than valid rows; then
   ``method="auto"``'s rule: the fused search against the exact chunked
   scan per call at N below 65,536 (the demo's shape, and bf16 at the
   eval shape);
7. the committed hard-copy demo through the port on the card: the data of
   ``scripts/make_copy_task_data.py --hard`` (run as a subprocess), the
   committed encoder and generator, an f32 flat index searched by B3
   (``method="pallas2"``), the port's ``evaluate`` with the demo's options
   over the 200 dev questions: EM, F1, retrieval recall (the JAX package
   recorded 0.955 / 0.955 / 1.0), B3's launches, B3 against its plain
   version on the inputs of evaluate's first scan (its T), and whether
   ``method="exact"`` returns the same ids;
8. evaluate at full width — ``load_or_initialize_model`` at
   ``--model_size large --precision bf16`` (bge-large towers, the ~1B
   llama/GQA generator, LoRA on; seeded random init), a bf16 flat index of
   1,300,000 x 1024 built as in phase 4 and saved, then
   ``python -m jsa_rag_tpu_torch.evaluate``'s ``main`` over 32 questions
   drawn from the corpus texts (``--load_index_path``, n_context 10, batch
   8, greedy fast_deocde1, generation_max_length 32 — cut from 256 for
   time): B3's launches during ``main``; recall@10 of main's own searches
   and recall@100 of its index on the same query embeddings against the
   exact-f32 oracle over the original float rows; 8 of main's greedy rows
   against a cache-free forward over prompt + generated prefix; each eval
   batch's wall time, split into the stages ``evaluate`` logs, and the
   device time of each batch's prefill and decode steps (CUDA events
   around main's own cached forwards);
9. B3 on that index against its plain version on the inputs of main's
   first scan, then timed
   with CUDA events at the eval shape (B=8, T from k=10) and at B=64 and
   B=512, beside the plain version (B=64), one ``torch.matmul`` of the bf16
   query against the rows (the bare product, no mask or top-T) and its
   bound; ``index.search`` per call at B=8 and B=64.

The last three lines are the card's name and power limit as nvidia-smi
gives them, the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
DIM = 1024
TOPK = 100
N_INDEX = 1_300_000  # the repo's flagship index geometry, 1.3M x 1024
N_TEXT = 16_384      # index rows the passage tower embeds from texts
MODEL_SIZE = "large"  # bge-large towers, the ~1B llama/GQA generator
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 rate, int8 and
# bf16 tensor-core rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
PEAK_BF16_OPS_PER_S = 989e12
RECALL_BAR = 0.99
DEMO_EM_BAR = 0.945  # the JAX package recorded 0.955 on the same data
# B3 against its plain version, relative to |q|·|x| (the largest a score's
# terms can sum to; for unit rows and queries, an absolute bound): the bf16
# kernel scores the (hi, lo) bf16 split of the f32 query (<= 2^-18
# sum|q_i x_i| per score, ~4e-6 for unit rows) and sums in another order
# than cuBLAS; the f32 kernel is an FMA loop against cuBLAS's f32 product
# (d * 2^-24 ~ 1.5e-5 worst case at d=256, ~1e-6 typical)
DENSE_RTOL = {"bfloat16": 1e-4, "float32": 1e-5}
# greedy decode at bf16 against a cache-free forward: the two run the same
# bf16 layers on different matmul shapes, so activations round differently;
# a generated token must be the cache-free argmax or within this many nats
# of it, and its captured log-prob must match to the same bound
GREEDY_TOL = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, iters: int) -> float:
    """Host clock per call of ``fn`` ending in a synchronise."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    """Least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate. -> (ms, "bytes" | "operations")."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def int8r_bound(b: int, n_rows: int, d: int, n_tiles: int, t: int):
    """B1: plane 1 and its scales read once, both query planes and scales
    read once, the candidates written once; 4*B*N*d int8 operations (two
    products, multiply and add)."""
    return bound(n_rows * d + n_rows * 4 + 2 * b * d + 2 * b * 4
                 + n_tiles * b * t * 8, 4 * b * n_rows * d,
                 PEAK_INT8_OPS_PER_S)


def dense_bound(b: int, n_rows: int, d: int, n_tiles: int, t: int):
    """B3 over bf16 rows: the rows read once, the query's hi and lo bf16
    planes read once, the candidates written once; 2*2*B*N*d bf16
    operations (two products, multiply and add)."""
    return bound(n_rows * d * 2 + 2 * b * d * 2 + n_tiles * b * t * 8,
                 4 * b * n_rows * d, PEAK_BF16_OPS_PER_S)


def compare_int8r(mt, args, what: str) -> float:
    """B1 against its plain version on the same inputs; -> max abs error.
    Ids must match except among tied scores, scores within 1e-5 relative."""
    import torch

    ks, ki = mt.scan_topt_int8r2(*args)
    ps, pi = mt.scan_topt_int8r2_plain(*args)
    torch.cuda.synchronize()
    err = (ks - ps).abs()
    bad = err > 1e-5 * ps.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} scores differ by "
                             f"more than 1e-5 relative")
    differ = ki != pi
    if bool(differ.any()):
        # a differing id must tie another candidate of its (tile, row) list
        for nt, r, p in differ.nonzero().tolist():
            row = ks[nt, r]
            if int((row == row[p]).sum()) < 2:
                raise AssertionError(f"{what}: id differs at tile {nt} row "
                                     f"{r} slot {p} without a tied score")
    max_err = float(err.max())
    log(f"  {what}: candidates {tuple(ks.shape)}, ids equal "
        f"{int((~differ).sum())}/{differ.numel()} (rest tied), "
        f"max_abs_err {max_err:.3g}")
    return max_err


def compare_dense(mt, q, emb, nv: int, tile: int, t: int, what: str):
    """B3 against its plain version; -> max abs error. Scores within
    DENSE_RTOL·|q|·|x| of the plain ones and the same exhausted (-1) slots;
    where the ids differ, the kernel's row must score (in f64 on the stored
    values) within twice that tolerance of the plain version's row."""
    import torch

    rtol = DENSE_RTOL[str(emb.dtype).removeprefix("torch.")]
    ks, ki = mt.scan_topt_dense(q, emb, nv, tile, t)
    ps, pi = mt.scan_topt_dense_plain(q, emb, nv, tile, t)
    torch.cuda.synchronize()
    live = pi >= 0
    if not torch.equal(ki >= 0, live):
        raise AssertionError(f"{what}: exhausted slots differ")
    row_norm = torch.linalg.vector_norm(emb, dim=1, dtype=torch.float32)
    tol = rtol * (q.norm(dim=1)[None, :, None]
                  * row_norm[pi.clamp(min=0).long()])
    err = torch.where(live, (ks - ps).abs(), 0.0)
    if bool((err > tol).any()):
        raise AssertionError(f"{what}: {int((err > tol).sum())} scores "
                             f"differ by more than {rtol}·|q|·|x|")
    differ = ki != pi
    where = differ.nonzero()
    if where.shape[0]:
        rows = ki[differ].long()
        true = (q.double()[where[:, 1]] * emb[rows].double()).sum(-1)
        gap = (true - ps[differ].double()).abs()
        if bool((gap > 2 * tol[differ]).any()):
            raise AssertionError(f"{what}: a differing id scores "
                                 f"{float(gap.max()):.3g} off the plain "
                                 f"version's pick")
    max_err = float(err.max())
    log(f"  {what}: candidates {tuple(ks.shape)}, ids equal "
        f"{int((~differ).sum())}/{differ.numel()} (rest within tolerance), "
        f"max_abs_err {max_err:.3g} (tolerance {rtol}·|q|·|x|)")
    return max_err


def compare_served(mt, call, what: str) -> float:
    """B3 against its plain version on the inputs of one recorded
    ``mips_topk_dense_t`` call, at the tile and T that call gave the
    kernel; -> max abs error."""
    (q, emb, k), kw, _ = call
    n = emb.shape[0]
    tile, t = mt.scan_geometry(n, min(k, n), kw["pool_n"])
    return compare_dense(mt, q.float().contiguous(), emb, kw["valid_n"],
                         tile, t, f"{what} B={q.shape[0]} N={n} valid="
                         f"{kw['valid_n']} d={emb.shape[1]} k={k} T={t}")


class KeepFloats:
    """Index stand-in for ``build_index``: forwards every write and keeps
    the float rows, which the exact oracle needs."""

    def __init__(self, index, rows):
        self._index, self._rows = index, rows

    def __getattr__(self, name):
        return getattr(self._index, name)

    def set_embeddings(self, start, block):
        self._rows[start:start + block.shape[0]] = block
        self._index.set_embeddings(start, block)


@contextlib.contextmanager
def recording(owner, name: str, limit: int | None = None):
    """Wrap ``owner.name`` (a function or method) so the arguments and
    result of each call (the first ``limit`` calls) are appended to the
    yielded list; restored on exit."""
    real = getattr(owner, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        if limit is None or len(calls) < limit:
            calls.append((args, kwargs, out))
        return out

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def forward_times(lm):
    """Bracket each cached forward (``lm._forward_with_cache``) run in the
    block by CUDA events; yields a list with one entry per decode, [prompt
    forward's event pair, [each one-token step's event pair]]. Read them
    after a synchronise; restored on exit."""
    import torch

    real = lm._forward_with_cache
    decodes = []

    def wrapper(p, cfg, input_ids, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(p, cfg, input_ids, *args, **kwargs)
        stop.record()
        if input_ids.shape[1] > 1 or not decodes:
            decodes.append([(start, stop), []])
        else:
            decodes[-1][1].append((start, stop))
        return out

    lm._forward_with_cache = wrapper
    try:
        yield decodes
    finally:
        lm._forward_with_cache = real


class BatchTimes(logging.Handler):
    """Collects the per-batch wall times and their stage split that
    ``evaluation.evaluate`` logs."""

    def __init__(self):
        super().__init__()
        self.seconds: list[float] = []
        self.stages: list[dict] = []

    def emit(self, record):
        if hasattr(record, "batch_s"):
            self.seconds.append(record.batch_s)
            self.stages.append(record.stage_s)


def clustered_rows(torch, g, n: int, d: int, centers, w):
    """Clustered power-law-spectrum unit rows, the corpus generator of
    scripts/analysis/storage_recall_bench.py (noise 0.25, spectrum 0.5)."""
    assign = torch.randint(0, centers.shape[0], (n,), generator=g,
                           device=centers.device)
    e = centers[assign] + 0.25 * w * torch.randn(
        (n, d), generator=g, device=centers.device)
    return e / e.norm(dim=1, keepdim=True)


def fill_clustered(torch, g, index, e32, lo: int, hi: int):
    """Rows [lo, hi) of the corpus: seeded clustered rows, written into the
    index and kept in ``e32``."""
    w = (torch.arange(DIM, dtype=torch.float32, device=e32.device)
         + 1.0) ** -0.5
    centers = torch.randn((4096, DIM), generator=g, device=e32.device) * w
    centers /= centers.norm(dim=1, keepdim=True)
    for s in range(lo, hi, 65_536):
        t = min(s + 65_536, hi)
        e32[s:t] = clustered_rows(torch, g, t - s, DIM, centers, w)
        index.set_embeddings(s, e32[s:t])
    torch.cuda.synchronize()


def write_passages(path: str, store):
    """The corpus jsonl: the text passages, then one short row per
    clustered index row."""
    with open(path, "w") as f:
        for i in range(N_TEXT):
            f.write(json.dumps(store[i]) + "\n")
        for lo in range(N_TEXT, N_INDEX, 100_000):
            f.write("".join(
                f'{{"id": "{i}", "title": "cluster", "text": "row {i}"}}\n'
                for i in range(lo, min(lo + 100_000, N_INDEX))))


def recall_against_oracle(torch, q, ids, e32, k: int) -> float:
    """Mean overlap of ``ids`` (B, k) with the exact f32 top-k over the
    original float rows."""
    from jsa_rag_tpu_torch.ops.mips import mips_topk_exact

    _, oracle = mips_topk_exact(q.float(), e32, k)
    return float(torch.tensor([
        len(set(a.tolist()) & set(o.tolist())) / k
        for a, o in zip(ids, oracle)]).mean())


# ------------------------------------------------------------ phases 4 + 5
def serve_phase(torch, mt, g, dev, work):
    """Phases 4 and 5; -> B1's numbers for the kernels line."""
    from jsa_rag_tpu_torch.data import PassageStore, SimpleTokenizer
    from jsa_rag_tpu_torch.data.passages import format_passage
    from jsa_rag_tpu_torch.index.build import build_index, make_encode_fn
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
    from jsa_rag_tpu_torch.models import (BERT_PRESETS, BertConfig,
                                          DualEncoderRetriever,
                                          RetrieverConfig)
    from jsa_rag_tpu_torch.ops.mips import mips_topk_exact
    from jsa_rag_tpu_torch.serve.__main__ import main as serve_main
    from jsa_rag_tpu_torch.serve.client import call_retrieve_api

    log(f"[4] serve: bge-large towers, int8r index {N_INDEX} x {DIM}")
    t0 = time.perf_counter()
    cfg = RetrieverConfig(bert=BertConfig(
        vocab_size=30522, pooling="cls_norm", **BERT_PRESETS[MODEL_SIZE]))
    retriever = DualEncoderRetriever(cfg, device=dev, generator=g).eval()
    n_params = sum(p.numel() for p in retriever.parameters())
    store = PassageStore.synthetic(N_TEXT, seed=SEED)
    tok = SimpleTokenizer(max_vocab=cfg.bert.vocab_size)
    for text in store.texts():  # number the words in corpus order: the
        tok.tokenize(text)      # build tokenises on two threads
    index = ShardedFlatIndex(N_INDEX, DIM, "int8r", device=dev)
    e32 = torch.empty((N_INDEX, DIM), dtype=torch.float32, device=dev)
    log(f"  towers: {n_params / 1e6:.1f} M parameters "
        f"({time.perf_counter() - t0:.1f} s)")
    stats = build_index(KeepFloats(index, e32), store,
                        make_encode_fn(retriever), tok, batch_size=256,
                        max_length=64)
    log(f"  build_index over {N_TEXT} passages: "
        f"{stats['runtime/indexing'][0]:.1f} s, "
        f"{stats['indexing/passages_per_sec'][0]:.0f} passages/s")
    t0 = time.perf_counter()
    fill_clustered(torch, g, index, e32, N_TEXT, N_INDEX)
    log(f"  clustered rows {N_TEXT}..{N_INDEX}: "
        f"{time.perf_counter() - t0:.1f} s")

    server = None
    try:
        t0 = time.perf_counter()
        index.save(os.path.join(work, "index"), n_files=16)
        write_passages(os.path.join(work, "passages.jsonl"), store)
        log(f"  saved index + passages: {time.perf_counter() - t0:.1f} s")
        del index
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        server = serve_main(["--index_path", os.path.join(work, "index"),
                             "--passages",
                             os.path.join(work, "passages.jsonl"),
                             "--port", "0", "--device", dev.type],
                            block=False)
        url = f"http://127.0.0.1:{server.port}"
        sidx = server.index
        index_bytes = sum(x.numel() * x.element_size() for x in (
            sidx.embeddings, sidx.scales, sidx.res, sidx.res_scales))
        log(f"  server up in {time.perf_counter() - t0:.1f} s; index on the "
            f"card: {index_bytes} bytes")

        # queries: (a) query-tower embeddings of corpus passage texts,
        # (b) near-duplicate rows (gold top-1), (c) rows perturbed as in
        # storage_recall_bench.py (recall)
        text_ids = torch.randint(0, N_TEXT, (32,), generator=g, device=dev)
        ids, mask = tok.encode_batch(
            [format_passage(store[int(i)]) for i in text_ids], 64)
        with torch.no_grad():
            q_text = retriever.embed_queries(torch.from_numpy(ids).to(dev),
                                             torch.from_numpy(mask).to(dev))
        gold = torch.randint(N_TEXT, N_INDEX, (32,), generator=g,
                             device=dev)
        q_dup = e32[gold] + 0.01 / DIM ** 0.5 * torch.randn(
            (32, DIM), generator=g, device=dev)
        q_dup /= q_dup.norm(dim=1, keepdim=True)
        rows = torch.randint(0, N_INDEX, (64,), generator=g, device=dev)
        q_pert = e32[rows] + 0.3 * torch.randn((64, DIM), generator=g,
                                               device=dev)
        q_pert /= q_pert.norm(dim=1, keepdim=True)
        requests = [q_text, q_dup, q_pert[:32], q_pert[32:]]
        host = [q.float().cpu().numpy() for q in requests]
        names = ["text", "near-duplicate", "perturbed", "perturbed"]

        with recording(sidx, "search") as dispatched:
            mt.scan_topt_int8r2.launches = 0  # main path starts
            with ThreadPoolExecutor(len(host)) as ex:
                answers = list(ex.map(
                    lambda q: call_retrieve_api(q, topk=TOPK, url=url),
                    host))
            latencies = []
            for r in range(16):
                t0 = time.perf_counter()
                call_retrieve_api(host[1 + r % 3], topk=TOPK, url=url)
                latencies.append(time.perf_counter() - t0)
            launches = mt.scan_topt_int8r2.launches  # main path ends
        buckets = {int(args[0].shape[0]) for args, _, _ in dispatched}
        if launches < 1:
            raise AssertionError("the serve path never launched B1")
        latencies.sort()
        p50_ms = 1e3 * latencies[len(latencies) // 2]
        log(f"  {len(host)} concurrent + 16 sequential /retrieve requests "
            f"(32 rows, topk {TOPK}): B1 launches {launches}, dispatch "
            f"row buckets {sorted(buckets)}, p50 latency {p50_ms:.1f} ms")

        # checks against the exact f32 oracle over the original float rows
        q_all = torch.cat(requests).float()
        served = []
        for docs, scores in answers:
            if any(len(row) != TOPK or not all(row) for row in docs):
                raise AssertionError("short or empty answer row")
            served.extend([[int(d["id"]) for d in row] for row in docs])
            s = torch.tensor(scores)
            if not (torch.isfinite(s).all() and (s[:, 1:] <= s[:, :-1]).all()):
                raise AssertionError("scores not finite and descending")
        served = torch.tensor(served, device=dev)
        if int(served.min()) < 0 or int(served.max()) >= N_INDEX:
            raise AssertionError("served id out of range")
        exact_s = (q_all[:, None, :] * e32[served]).sum(-1)
        served_scores = torch.tensor(
            [s for _, scores in answers for s in scores], device=dev)
        score_err = float((served_scores - exact_s).abs().max())
        _, oracle = mips_topk_exact(q_all, e32, TOPK)
        recall = torch.tensor([
            len(set(a.tolist()) & set(o.tolist())) / TOPK
            for a, o in zip(served, oracle)])
        top1_ok = (served[32:64, 0] == gold).all().item()
        per_set = {}
        o = 0
        for name, q in zip(names, requests):
            per_set.setdefault(name, []).extend(
                recall[o:o + q.shape[0]].tolist())
            o += q.shape[0]
        for name, vals in per_set.items():
            log(f"  recall@{TOPK} {name}: {sum(vals) / len(vals):.4f} "
                f"(min {min(vals):.2f}, {len(vals)} queries)")
        mean_recall = float(recall.mean())
        log(f"  recall@{TOPK} all: {mean_recall:.4f}; near-duplicate gold "
            f"top-1: {top1_ok}; served score vs exact f32 max abs err "
            f"{score_err:.3g}")
        if not top1_ok:
            raise AssertionError("near-duplicate queries lost their gold row")
        if mean_recall < RECALL_BAR:
            raise AssertionError(f"recall@{TOPK} {mean_recall:.4f} < "
                                 f"{RECALL_BAR}")
        if score_err > 1e-3:
            raise AssertionError(f"served scores off by {score_err:.3g}")

        # ---------------------------- 5 B1 times at the serve path shapes
        log("[5] B1 timing on the served index")
        k_pad = 1 << (TOPK - 1).bit_length()  # the batcher's k bucket
        k_sel = min(sidx.refine_r * k_pad, sidx.n_padded)
        t = mt._pool_t(k_sel, sidx.n_passages, 256, 4)
        n_rows = sidx.embeddings.shape[0]
        n_tiles = -(-n_rows // 256)
        # against the plain version at every row bucket the batcher
        # dispatched (and 32, 64), on the served index with the served T
        max_err = 0.0
        for b in sorted(buckets | {32, 64}):
            qb = q_all[torch.arange(b, device=dev) % q_all.shape[0]]
            args = (*mt.quantize_int8_residual(qb), sidx.embeddings,
                    sidx.scales, sidx.n_passages, 256, t)
            max_err = max(max_err, compare_int8r(
                mt, args, f"served index B={b} N={n_rows} T={t}"))
        timing = {}
        for b in (64, 512):
            qb = e32[torch.randint(0, N_INDEX, (b,), generator=g,
                                   device=dev)]
            args = (*mt.quantize_int8_residual(qb), sidx.embeddings,
                    sidx.scales, sidx.n_passages, 256, t)
            if b == 64:
                plain_ms = cuda_ms(lambda: mt.scan_topt_int8r2_plain(*args),
                                   3, warmup=1)
            ms = cuda_ms(lambda: mt.scan_topt_int8r2(*args), 20)
            bound_ms, bound_by = int8r_bound(b, n_rows, DIM, n_tiles, t)
            both = torch.cat([args[0], args[2]])
            lib_ms = cuda_ms(
                lambda: torch._int_mm(both, sidx.embeddings.t()), 5)
            timing[b] = (ms, bound_ms, bound_by, lib_ms)
            log(f"  B={b}: B1 {ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}), _int_mm of both products {lib_ms:.3f} ms")
        log(f"  B=64 plain version {plain_ms:.3f} ms")
        # the device side of one request: index.search (quantise, scan,
        # merge, refine) on a request's rows, host clock to a synchronise
        search_ms = {b: host_ms(lambda: sidx.search(q_all[32:32 + b], k_pad),
                                10) for b in (32, 64)}
        log(f"  index.search (k={k_pad}) per call: B=32 "
            f"{search_ms[32]:.3f} ms, B=64 {search_ms[64]:.3f} ms; request "
            f"p50 {p50_ms:.1f} ms")
    finally:
        if server is not None:
            server.stop()
    ms, bound_ms, bound_by, lib_ms = timing[64]
    ms512, bound512, by512, lib512 = timing[512]
    return {
        "name": "topt_int8r2",
        "route": "cuda",
        "source": "jsa_rag_tpu_torch/csrc/topt_int8r2.cu",
        "replaces": "jsa_rag_tpu/ops/mips_pallas2.py:724",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
        "shape": {"B": 64, "N": n_rows, "d": DIM, "tile_n": 256, "T": t},
        "at_B512": {"ms": ms512, "bound_ms": bound512, "bound_by": by512,
                    "library_ms": lib512},
        "serve_p50_ms": p50_ms,
        "search_ms": search_ms,
        "recall_at_100": mean_recall,
    }


# ---------------------------------------------------------------- phase 6
def dense_phase(torch, mt, g, dev):
    """Phase 6; -> (max abs error, the auto-rule timings)."""
    from jsa_rag_tpu_torch.ops import mips

    log("[6] B3 against its plain version on the card")
    max_err = 0.0
    for dtype, b, n, nv, d, k_sel in (
            (torch.bfloat16, 64, 262_144, 262_144 - 777, DIM, 400),
            (torch.float32, 5, 4099, 3000, 256, 4096)):
        e = torch.randn((n, d), generator=g, device=dev)
        e = (e / e.norm(dim=1, keepdim=True)).to(dtype)
        q = torch.randn((b, d), generator=g, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        t = mt._pool_t(k_sel, nv, 256, 4)
        max_err = max(max_err, compare_dense(
            mt, q, e, nv, 256, t,
            f"{dtype} B={b} N={n} valid={nv} d={d} k_sel={k_sel} T={t}"))
        del e
    torch.cuda.empty_cache()

    # method="auto" takes the exact chunked scan below
    # mips.AUTO_FUSED_MIN_ROWS rows: the fused search against it on both
    # sides of that threshold, per call (CUDA events over 20 back-to-back
    # calls), at the demo's shape and at the eval shape over bf16 rows.
    # The rows come from their own generator, so the corpus of later
    # phases does not depend on this sweep.
    ga = torch.Generator(device=dev).manual_seed(SEED + 1)
    auto_rule = []
    shapes = [(torch.float32, 16, 4096, 4000, 256, 4)] + [
        (torch.bfloat16, 8, n, n, DIM, 10)
        for n in (4096, 8192, 16_384, 32_768, 65_536)]
    for dtype, b, n, nv, d, k in shapes:
        e = torch.randn((n, d), generator=ga, device=dev)
        e = (e / e.norm(dim=1, keepdim=True)).to(dtype)
        q = torch.randn((b, d), generator=ga, device=dev)
        ms = {m: cuda_ms(lambda: mips.mips_topk_t(q, e, k, method=m,
                                                  valid_n=nv, pool_n=nv), 20)
              for m in ("pallas2", "exact")}
        auto_rule.append({"dtype": str(dtype).removeprefix("torch."),
                          "B": b, "N": n, "d": d, "k": k,
                          "fused_ms": ms["pallas2"], "exact_ms": ms["exact"],
                          "auto": mips.auto_method(dev.type, n)})
        log(f"  search per call, {dtype} B={b} N={n} d={d} k={k}: fused "
            f"(B3) {ms['pallas2']:.3f} ms, exact scan {ms['exact']:.3f} ms; "
            f"auto picks {mips.auto_method(dev.type, n)}")
    return max_err, auto_rule


# ---------------------------------------------------------------- phase 7
def demo_phase(torch, mt, dev, work) -> dict:
    from jsa_rag_tpu_torch.config import Options
    from jsa_rag_tpu_torch.convert import load_demo_artifacts
    from jsa_rag_tpu_torch.data.passages import (PassageStore,
                                                 load_passages_jsonl)
    from jsa_rag_tpu_torch.evaluation import evaluate
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
    from jsa_rag_tpu_torch.ops import mips
    from jsa_rag_tpu_torch.train.rag_model import RAGModel

    log("[7] hard-copy demo through the port (committed artifacts, f32 "
        "index searched by B3)")
    t0 = time.perf_counter()
    data = os.path.join(work, "hardcopy")
    subprocess.run([sys.executable, os.path.join(
        "scripts", "make_copy_task_data.py"), "--out", data, "--hard",
        "--n_topics", "4000", "--n_train_topics", "3000", "--n_eval", "200",
        "--train_per_topic", "4"], check=True, capture_output=True,
        timeout=300)
    art = os.path.join("docs", "demo", "artifacts")
    retriever, lm_cfg, gen, tok = load_demo_artifacts(
        os.path.join(art, "hard_encoder.pkl"),
        os.path.join(art, "hard_generator.pkl"), device=dev)
    # the demo's options (docs/demo/e2e_hard_copy_task.py:57-69)
    opt = Options(task="qa", gold_score_mode="rag",
                  gen_method="fast_deocde1", qa_prompt_format="{question}",
                  n_context=4, text_maxlength=96, target_maxlength=8,
                  generation_max_length=4, per_gpu_batch_size=16,
                  per_gpu_embedder_batch_size=256, use_lora=False,
                  precision="fp32", checkpoint_dir=os.path.join(work, "ck"),
                  name="hard-copy", device=dev.type)
    store = PassageStore(passages=load_passages_jsonl(
        os.path.join(data, "passages.jsonl")))
    model = RAGModel(opt, retriever, lm_cfg, tok, tok, store)
    params = {"retriever": retriever, "generator": gen}
    index = ShardedFlatIndex(len(store), retriever.cfg.bert.hidden,
                             "float32", device=dev, method="pallas2")
    model.build_index(index, params)
    with recording(mips, "mips_topk_dense_t", 1) as scans:
        mt.scan_topt_dense.launches = 0
        m = evaluate(model, index, params, opt,
                     os.path.join(data, "dev.jsonl"))
        launches = mt.scan_topt_dense.launches
    max_err = compare_served(mt, scans[0], "evaluate's first scan:")
    with open(os.path.join(data, "dev.jsonl")) as f:
        questions = [json.loads(line)["question"] for line in f]
    q = model.embed_queries(params, questions)
    _, ids_b3 = index.search(q, opt.n_context)
    _, ids_exact = mips.mips_topk_t(q, index.embeddings, opt.n_context,
                                    method="exact",
                                    valid_n=index.n_passages)
    same = bool(torch.equal(ids_b3, ids_exact))
    log(f"  {len(questions)} dev questions, {len(store)} passages: EM "
        f"{m['exact_match']:.4f}, F1 {m['f1']:.4f}, retrieval recall "
        f"{m['retrieval_recall']:.4f} (JAX package, same data and weights: "
        f"0.955 / 0.955 / 1.0); B3 launches {launches}; method='exact' "
        f"returns the same ids: {same} ({time.perf_counter() - t0:.1f} s)")
    if launches < 1:
        raise AssertionError("the demo's search never launched B3")
    if not same:
        raise AssertionError("B3 and the exact scan retrieve different ids")
    if m["retrieval_recall"] != 1.0 or m["exact_match"] < DEMO_EM_BAR:
        raise AssertionError(f"demo EM {m['exact_match']} / recall "
                             f"{m['retrieval_recall']} below the bar")
    return {"exact_match": m["exact_match"], "f1": m["f1"],
            "retrieval_recall": m["retrieval_recall"], "launches": launches,
            "exact_ids_equal": same, "max_abs_err": max_err}


# ------------------------------------------------------------ phases 8 + 9
def check_greedy_rows(torch, call, rows: int = 8):
    """Hold ``rows`` rows of one recorded ``greedy_generate`` call to a
    cache-free ``lm_logits`` over prompt + generated prefix, up to each
    row's EOS. -> (exact argmax steps, steps, max |log-prob diff|)."""
    from jsa_rag_tpu_torch.models.lm import lm_logits

    (params, cfg, ids, mask), kw, (toks, lps) = call
    ids, mask, toks, lps = ids[:rows], mask[:rows], toks[:rows], lps[:rows]
    p = ids.shape[1]
    full = torch.cat([ids.long(), toks], dim=1)
    full_mask = torch.cat([mask.long(), torch.ones_like(toks)], dim=1)
    with torch.no_grad():
        ref = torch.log_softmax(lm_logits(params, cfg, full, full_mask),
                                dim=-1)[:, p - 1:-1]
    exact = steps = 0
    worst = 0.0
    for r in range(rows):
        for t in range(toks.shape[1]):
            tok = int(toks[r, t])
            top = float(ref[r, t].max())
            mine = float(ref[r, t, tok])
            steps += 1
            exact += int(tok == int(ref[r, t].argmax()))
            worst = max(worst, abs(float(lps[r, t]) - mine))
            if top - mine > GREEDY_TOL:
                raise AssertionError(
                    f"greedy row {r} step {t}: token {tok} is {top - mine:.3f}"
                    f" nats below the cache-free argmax")
            if tok == kw["eos_id"]:
                break
    if worst > GREEDY_TOL:
        raise AssertionError(f"captured log-probs off by {worst:.3f}")
    return exact, steps, worst


def eval_phase(torch, mt, g, dev, work) -> dict:
    """Phases 8 and 9; -> B3's numbers for the kernels line."""
    from jsa_rag_tpu_torch import evaluate as evaluate_cli
    from jsa_rag_tpu_torch.config import Options
    from jsa_rag_tpu_torch.data import PassageStore
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
    from jsa_rag_tpu_torch.model_io import load_or_initialize_model
    from jsa_rag_tpu_torch.models import lm
    from jsa_rag_tpu_torch.ops import mips
    from jsa_rag_tpu_torch.train import rag_model

    log(f"[8] evaluate at full width: bge-large towers, ~1B llama/GQA "
        f"generator (bf16, LoRA), bf16 index {N_INDEX} x {DIM}")
    t0 = time.perf_counter()
    store = PassageStore.synthetic(N_TEXT, seed=SEED)
    passages = os.path.join(work, "passages.jsonl")
    questions = os.path.join(work, "questions.jsonl")
    rows = torch.randperm(N_TEXT, generator=torch.Generator().manual_seed(
        SEED))[:32].tolist()
    with open(questions, "w") as f:
        for i in rows:
            words = store[i]["text"].split()
            f.write(json.dumps({"question": " ".join(words[:6]),
                                "answers": [" ".join(words[6:8])]}) + "\n")
    argv = ["--model_size", MODEL_SIZE, "--precision", "bf16",
            "--max_vocab", "32000", "--seed", str(SEED), "--device", dev.type,
            "--index_dtype", "bfloat16", "--n_context", "10",
            "--per_gpu_batch_size", "8", "--generation_max_length", "32",
            "--passages", passages, "--eval_data", questions,
            "--load_index_path", os.path.join(work, "index_bf16"),
            "--checkpoint_dir", os.path.join(work, "ck"),
            "--name", "eval-full", "--write_results", "true"]
    opt = Options.from_args(argv)
    model, params, _ = load_or_initialize_model(opt, store)
    n_gen = sum(x.numel() for x in [params["generator"]["embed"],
                                    params["generator"]["lm_head"]]
                + [v for layer in params["generator"]["layers"]
                   for v in layer.values()])
    n_ret = sum(p.numel() for p in params["retriever"].parameters())
    log(f"  model: towers {n_ret / 1e6:.1f} M, generator {n_gen / 1e6:.1f} "
        f"M parameters ({time.perf_counter() - t0:.1f} s)")
    del params["generator"], params["lora"]  # main makes its own

    index = ShardedFlatIndex(N_INDEX, DIM, "bfloat16", device=dev)
    e32 = torch.empty((N_INDEX, DIM), dtype=torch.float32, device=dev)
    stats = model.build_index(KeepFloats(index, e32), params)
    log(f"  build_index over {N_TEXT} passages: "
        f"{stats['runtime/indexing'][0]:.1f} s")
    fill_clustered(torch, g, index, e32, N_TEXT, N_INDEX)
    t0 = time.perf_counter()
    index.save(os.path.join(work, "index_bf16"), n_files=16)
    if not os.path.exists(passages):
        write_passages(passages, store)
    log(f"  clustered rows and save: {time.perf_counter() - t0:.1f} s")
    del model, params, index
    torch.cuda.empty_cache()

    times = BatchTimes()
    eval_log = logging.getLogger("jsa_rag_tpu_torch.evaluation")
    eval_log.addHandler(times)
    eval_log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        with recording(ShardedFlatIndex, "search") as searches, \
                recording(mips, "mips_topk_dense_t", 1) as scans, \
                recording(rag_model, "greedy_generate", 1) as decodes, \
                forward_times(lm) as forwards:
            mt.scan_topt_dense.launches = 0  # main path starts
            results = evaluate_cli.main(argv)
            launches = mt.scan_topt_dense.launches  # main path ends
    finally:
        eval_log.removeHandler(times)
    main_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # (prefill ms, [decode step ms]) of each generate, in batch order
    fwd_ms = [(a.elapsed_time(b), [s.elapsed_time(e) for s, e in steps])
              for (a, b), steps in forwards]
    del forwards
    metrics = results["questions.jsonl"]
    log(f"  evaluate main: {main_s:.1f} s, B3 launches {launches}, "
        f"metrics " + ", ".join(f"{k} {v:.4f}" for k, v in
                                sorted(metrics.items())))
    if len(fwd_ms) != len(times.seconds):
        raise AssertionError(f"{len(fwd_ms)} decodes for "
                             f"{len(times.seconds)} eval batches")
    # where the time goes: main's own batches, stage by stage (host clock;
    # each stage ends in a host copy), and the generator's cached forwards
    # on the device (CUDA events)
    stages = []
    for n, (s, st, (pre, dec)) in enumerate(zip(times.seconds, times.stages,
                                                fwd_ms)):
        stages.append({**st, "batch": s, "prefill_device": pre / 1e3,
                       "decode_steps": len(dec),
                       "decode_device": sum(dec) / 1e3})
        log(f"  eval batch {n}: {s:.3f} s = " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items())
            + f"; on the device: prefill {pre:.1f} ms, {len(dec)} decode "
            f"steps {sum(dec):.1f} ms ({sum(dec) / max(len(dec), 1):.2f} "
            f"ms each)")
    if launches < 1:
        raise AssertionError("the evaluate path never launched B3")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")

    sidx = searches[0][0][0]  # main's own index
    q = torch.cat([args[1] for args, _, _ in searches]).float()
    got10 = torch.cat([out[1] for _, _, out in searches])
    r10 = recall_against_oracle(torch, q, got10, e32, 10)
    _, got100 = sidx.search(q, TOPK)
    r100 = recall_against_oracle(torch, q, got100, e32, TOPK)
    log(f"  recall against exact f32 over the original rows, {q.shape[0]} "
        f"query-tower embeddings of main's searches: @10 {r10:.4f}, @100 "
        f"{r100:.4f}")
    if min(r10, r100) < RECALL_BAR:
        raise AssertionError(f"recall {r10:.4f} / {r100:.4f} < {RECALL_BAR}")
    exact, steps, worst = check_greedy_rows(torch, decodes[0])
    log(f"  8 greedy rows of main's first batch against a cache-free "
        f"forward: {exact}/{steps} steps the exact argmax (the rest within "
        f"{GREEDY_TOL} nats), log-probs within {worst:.4f}")
    del decodes

    # ------------------------------------------------------------- 9 times
    log("[9] B3 on the served bf16 index: against its plain version at "
        "main's first scan, then timed")
    max_err = compare_served(mt, scans[0], "main's first scan:")
    del scans
    n_rows = sidx.embeddings.shape[0]
    n_tiles = -(-n_rows // 256)
    timing = {}
    for b in (8, 64, 512):
        qb = e32[torch.randint(0, N_INDEX, (b,), generator=g, device=dev)]
        _, tb = mt.scan_geometry(n_rows, 10 if b == 8 else TOPK,
                                 sidx.n_passages)
        ms = cuda_ms(lambda: mt.scan_topt_dense(qb, sidx.embeddings,
                                                sidx.n_passages, 256, tb),
                     20)
        qh = qb.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(qh, sidx.embeddings.t()), 5)
        bound_ms, bound_by = dense_bound(b, n_rows, DIM, n_tiles, tb)
        timing[b] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "T": tb}
        if b == 64:
            plain_ms = cuda_ms(lambda: mt.scan_topt_dense_plain(
                qb, sidx.embeddings, sidx.n_passages, 256, tb), 3, warmup=1)
        log(f"  B={b} T={tb}: B3 {ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}), torch.matmul bf16 {lib_ms:.3f} ms")
    log(f"  B=64 plain version {plain_ms:.3f} ms")
    q64 = q[torch.arange(64, device=dev) % q.shape[0]]
    search_ms = {b: host_ms(lambda: sidx.search(q64[:b], 10), 10)
                 for b in (8, 64)}
    log(f"  index.search (k=10) per call: B=8 {search_ms[8]:.3f} ms, B=64 "
        f"{search_ms[64]:.3f} ms")
    main64 = timing[64]
    return {
        "name": "topt_dense",
        "route": "cuda",
        "source": "jsa_rag_tpu_torch/csrc/topt_dense.cu",
        "replaces": "jsa_rag_tpu/ops/mips_pallas2.py:176",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main64["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main64["bound_ms"],
        "bound_by": main64["bound_by"],
        "library_ms": main64["library_ms"],
        "shape": {"B": 64, "N": n_rows, "d": DIM, "tile_n": 256,
                  "T": main64["T"], "dtype": "bfloat16"},
        "at_B8": timing[8],
        "at_B512": timing[512],
        "search_ms": search_ms,
        "recall_at_10": r10,
        "recall_at_100": r100,
        "eval_batch_s": times.seconds,
        "eval_stages_s": stages,
        "greedy_exact_steps": [exact, steps],
    }


def main() -> None:
    t_start = time.perf_counter()
    # ---------------------------------------------------------- 1 environment
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "smoke needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    from jsa_rag_tpu_torch.device import exact_f32_matmul

    exact_f32_matmul()
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, TF32 off")

    # ---------------------------------------------------------------- 2 build
    from jsa_rag_tpu_torch.ops import _build
    from jsa_rag_tpu_torch.ops import mips_topt as mt

    t0 = time.perf_counter()
    mt._kernel_libs()
    log(f"[2] built {', '.join(mt.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in mt.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # --------------------------------------------- 3 B1 against plain
    log("[3] B1 against its plain version on the card")
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for b, n, nv, k_sel in ((64, 262_144, 262_144 - 777, 400),
                            (5, 4099, 3000, 4096)):
        e = torch.randn((n, DIM), generator=g, device=dev)
        v1, s1, _, _ = mt.quantize_int8_residual(e)
        del e
        qv1, qs1, qv2, qs2 = mt.quantize_int8_residual(
            torch.randn((b, DIM), generator=g, device=dev))
        t = mt._pool_t(k_sel, nv, 256, 4)
        args = (qv1, qs1, qv2, qs2, v1, s1.reshape(1, -1), nv, 256, t)
        max_err = max(max_err, compare_int8r(
            mt, args, f"B={b} N={n} valid={nv} k_sel={k_sel} T={t}"))
        del v1, s1
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        b1 = serve_phase(torch, mt, g, dev, work)
        b1["max_abs_err"] = max(b1["max_abs_err"], max_err)
        torch.cuda.empty_cache()
        dense_err, auto_rule = dense_phase(torch, mt, g, dev)
        demo = demo_phase(torch, mt, dev, work)
        torch.cuda.empty_cache()
        b3 = eval_phase(torch, mt, g, dev, work)
        b3["max_abs_err"] = max(b3["max_abs_err"], dense_err,
                                demo["max_abs_err"])
        b3["hard_copy_demo"] = demo
        b3["auto_rule"] = auto_rule
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"smoke took {time.perf_counter() - t_start:.0f} s")
    log(smi)
    log(json.dumps({"kernels": [b1, b3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
