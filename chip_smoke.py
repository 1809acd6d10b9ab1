#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: one CUDA card, the index-serving path at
full width, every kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure ends the run with a non-zero exit and no result line):

1. environment — the card's name and power limit, CUDA present, TF32 off;
2. build — ``nvcc`` builds every kernel of the path from ``csrc/``;
3. kernels against their plain versions on the card, at the index-tile
   shapes the serve path gives them (d=1024, N=262,144 with 777 padded rows,
   B=64, 400 candidates; and B=5, N=4099 with more candidates than valid
   rows);
4. serve at full width — bge-large-geometry towers (24 x 1024, cls_norm,
   vocab 30522; seeded random init, no checkpoint is in the repository), an
   int8r index of 1,300,000 x 1024 whose first 16,384 rows the passage
   tower builds from ``PassageStore.synthetic`` texts and whose rest is a
   seeded clustered corpus made on the card; saved, then served by
   ``python -m jsa_rag_tpu_torch.serve``'s ``main``; concurrent
   ``/retrieve`` requests at topk 100 (query-tower embeddings of corpus
   texts, near-duplicate rows, perturbed rows); gold top-1, recall@100
   against the chunked exact-f32 oracle over the original float rows, the
   kernels' launches during this phase, p50 request latency;
5. on the served index: each kernel against its plain version at every row
   bucket the batcher dispatched in phase 4 (and 32, 64), then timed at the
   serve path's shapes beside its plain version, one PyTorch library call
   for the same products, and its bound.

The last three lines are the card's name and power limit as nvidia-smi
gives them, the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 rate, int8 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
RECALL_BAR = 0.99


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


def scan_bound(b: int, n_rows: int, d: int, n_tiles: int, t: int):
    """Least time the card could take for one scan: each input read once,
    each output written once, over the HBM rate; 4*B*N*d int8 operations
    (two products, multiply and add) over the int8 rate. -> (ms, by)."""
    bytes_moved = (n_rows * d + n_rows * 4 + 2 * b * d + 2 * b * 4
                   + n_tiles * b * t * 8)
    ops = 4 * b * n_rows * d
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare_scan(mt, args, what: str) -> float:
    """Kernel against plain version on the same inputs; -> max abs error.
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


class RecordRows:
    """Wraps a served index's ``search`` to record the row count of every
    dispatch the batcher makes (its power-of-two buckets)."""

    def __init__(self, index):
        self.rows: set[int] = set()
        self._search = index.search
        index.search = self

    def __call__(self, queries, k):
        self.rows.add(int(queries.shape[0]))
        return self._search(queries, k)


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


def clustered_rows(torch, g, n: int, d: int, centers, w):
    """Clustered power-law-spectrum unit rows, the corpus generator of
    scripts/analysis/storage_recall_bench.py (noise 0.25, spectrum 0.5)."""
    assign = torch.randint(0, centers.shape[0], (n,), generator=g,
                           device=centers.device)
    e = centers[assign] + 0.25 * w * torch.randn(
        (n, d), generator=g, device=centers.device)
    return e / e.norm(dim=1, keepdim=True)


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
    mt._kernel_lib()
    log(f"[2] built topt_int8r2 in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("topt_int8r2").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # --------------------------------------------- 3 kernels against plain
    log("[3] kernel against its plain version on the card")
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
        max_err = max(max_err, compare_scan(
            mt, args, f"B={b} N={n} valid={nv} k_sel={k_sel} T={t}"))
        del v1, s1
    torch.cuda.empty_cache()

    # ------------------------------------------------- 4 serve at full width
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
        vocab_size=30522, pooling="cls_norm", **BERT_PRESETS["large"]))
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
    w = (torch.arange(DIM, dtype=torch.float32, device=dev) + 1.0) ** -0.5
    centers = torch.randn((4096, DIM), generator=g, device=dev) * w
    centers /= centers.norm(dim=1, keepdim=True)
    for lo in range(N_TEXT, N_INDEX, 65_536):
        hi = min(lo + 65_536, N_INDEX)
        e32[lo:hi] = clustered_rows(torch, g, hi - lo, DIM, centers, w)
        index.set_embeddings(lo, e32[lo:hi])
    torch.cuda.synchronize()
    log(f"  clustered rows {N_TEXT}..{N_INDEX}: "
        f"{time.perf_counter() - t0:.1f} s")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    server = None
    try:
        t0 = time.perf_counter()
        index.save(os.path.join(work, "index"), n_files=16)
        with open(os.path.join(work, "passages.jsonl"), "w") as f:
            for i in range(N_TEXT):
                f.write(json.dumps(store[i]) + "\n")
            for lo in range(N_TEXT, N_INDEX, 100_000):
                f.write("".join(
                    f'{{"id": "{i}", "title": "cluster", "text": "row {i}"}}\n'
                    for i in range(lo, min(lo + 100_000, N_INDEX))))
        log(f"  saved index + passages: {time.perf_counter() - t0:.1f} s")
        del index
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        server = serve_main(["--index_path", os.path.join(work, "index"),
                             "--passages",
                             os.path.join(work, "passages.jsonl"),
                             "--port", "0", "--device", "cuda"],
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

        dispatched = RecordRows(sidx)
        mt.scan_topt_int8r2.launches = 0  # main path starts
        with ThreadPoolExecutor(len(host)) as ex:
            answers = list(ex.map(
                lambda q: call_retrieve_api(q, topk=TOPK, url=url), host))
        latencies = []
        for r in range(16):
            t0 = time.perf_counter()
            call_retrieve_api(host[1 + r % 3], topk=TOPK, url=url)
            latencies.append(time.perf_counter() - t0)
        launches = mt.scan_topt_int8r2.launches  # main path ends
        if launches < 1:
            raise AssertionError("the serve path never launched the kernel")
        latencies.sort()
        p50_ms = 1e3 * latencies[len(latencies) // 2]
        log(f"  {len(host)} concurrent + 16 sequential /retrieve requests "
            f"(32 rows, topk {TOPK}): kernel launches {launches}, dispatch "
            f"row buckets {sorted(dispatched.rows)}, p50 latency "
            f"{p50_ms:.1f} ms")

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

        # ---------------------------- 5 kernel times at the serve path shapes
        log("[5] kernel timing on the served index")
        k_pad = 1 << (TOPK - 1).bit_length()  # the batcher's k bucket
        k_sel = min(sidx.refine_r * k_pad, sidx.n_padded)
        t = mt._pool_t(k_sel, sidx.n_passages, 256, 4)
        n_rows = sidx.embeddings.shape[0]
        n_tiles = -(-n_rows // 256)
        # against the plain version at every row bucket the batcher
        # dispatched (and 32, 64), on the served index with the served T
        for b in sorted(dispatched.rows | {32, 64}):
            qb = q_all[torch.arange(b, device=dev) % q_all.shape[0]]
            args = (*mt.quantize_int8_residual(qb), sidx.embeddings,
                    sidx.scales, sidx.n_passages, 256, t)
            max_err = max(max_err, compare_scan(
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
            bound_ms, bound_by = scan_bound(b, n_rows, DIM, n_tiles, t)
            both = torch.cat([args[0], args[2]])
            try:
                lib_ms = cuda_ms(
                    lambda: torch._int_mm(both, sidx.embeddings.t()), 5)
            except RuntimeError as err:  # the yardstick only
                log(f"  torch._int_mm unavailable at B={b}: {err}")
                lib_ms = None
            timing[b] = (ms, bound_ms, bound_by, lib_ms)
            log(f"  B={b}: kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}), _int_mm of both products "
                f"{lib_ms if lib_ms is None else round(lib_ms, 3)} ms")
        log(f"  B=64 plain version {plain_ms:.3f} ms")
        # the device side of one request: index.search (quantise, scan,
        # merge, refine) on a request's rows, host clock to a synchronise
        search_ms = {}
        for b in (32, 64):
            qb = q_all[32:32 + b]  # near-duplicate and perturbed rows
            for _ in range(2):
                sidx.search(qb, k_pad)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                sidx.search(qb, k_pad)
            torch.cuda.synchronize()
            search_ms[b] = (time.perf_counter() - t0) * 100
        log(f"  index.search (k={k_pad}) per call: B=32 "
            f"{search_ms[32]:.3f} ms, B=64 {search_ms[64]:.3f} ms; request "
            f"p50 {p50_ms:.1f} ms")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(work, ignore_errors=True)

    log(f"smoke took {time.perf_counter() - t_start:.0f} s")
    ms, bound_ms, bound_by, lib_ms = timing[64]
    ms512, bound512, by512, lib512 = timing[512]
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "topt_int8r2",
        "route": "cuda",
        "source": "jsa_rag_tpu_torch/csrc/topt_int8r2.cu",
        "replaces": "jsa_rag_tpu/ops/mips_pallas2.py:724",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
