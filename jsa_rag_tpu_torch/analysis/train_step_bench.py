"""jsa training-step time split into its parts, on one device (counterpart
of ``scripts/analysis/train_step_bench.py``).

Mirrors the reference's iter_stats runtime rows (train.py:193-271): for
each step

- ``batch``: ``RAGModel.build_batch("jsa")`` — ``retrieve_pair`` (the
  prior's and the posterior's searches and their union) and the union's
  tokenisation (host clock, ending in a synchronise);
- ``step``: the loss (retriever scoring, the MIS chain, the generator's
  CE), its backward and the AdamW update (``train/step.py``'s step): host
  clock around it, and its device time by CUDA events, split into
  ``grad`` (loss and backward) and ``update`` (the optimizer);

after two warm-up steps, with the per-step lists, their medians,
examples/s from the medians, and the peak device memory. The step structure
is the flagship's (mis_step 50, 10 passages; run-jsa-nq-no-rebuild.sh:45-50)
at the geometry of ``--size``; the index is filled with seeded random unit
rows made on the device (no corpus embed), the corpus texts are synthetic::

    python -m jsa_rag_tpu_torch.analysis.train_step_bench --flagship \\
        --n 1300000 --steps 8
    python -m jsa_rag_tpu_torch.analysis.train_step_bench --device cpu \\
        --size tiny --n 4096 --steps 2 --mis 4 --n_context 3 \\
        --text_maxlength 32

``--flagship`` takes the reference flagship's flags (large presets: bge-large
towers and the ~1B GQA generator, LoRA, query-side retriever training,
decoupled posterior, bf16 compute and bf16 parameter storage, both remat
flags, text 512 / target 256) over a hybrid index, whose coarse scan is
kernel B2; without it the index is float16 (the JAX bench's default
storage: kernel B4). The JAX script's ``--unfused`` (a separate jitted grad
and update beside the fused program) has no counterpart: the port's step is
one eager call of the loss, the backward and the update, and the split
above comes from its own events. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..bench import CHUNK, platform_of, unit_gaussian
from ..config import Options
from ..device import resolve_device
from ..index.flat import ShardedFlatIndex
from ..model_io import load_or_initialize_model
from ..train.modes import StepRng
from ..train.optim import set_optim
from ..train.step import make_train_step
from .synthetic import uniform_passages

WARMUP = 2


class Span:
    """Time between ``start`` and ``stop``: CUDA events on the card (read
    ``ms`` after a synchronise), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [self._mark()]

    def stop(self) -> None:
        self.marks.append(self._mark())

    def ms(self) -> float:
        a, b = self.marks
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


FLAGSHIP = dict(model_size="large", text_maxlength=512, target_maxlength=256,
                use_lora=True, query_side_retriever_training=True,
                decouple_encoder=True, use_gradient_checkpoint_generator=True,
                use_gradient_checkpoint_retriever=True, precision="bf16",
                param_dtype="bfloat16", temperature_jsa=0.1,
                weight_decay=0.01, dropout=0.1)


def bench_options(args) -> Options:
    kw = dict(model_size=args.size, text_maxlength=args.text_maxlength,
              target_maxlength=16)
    if args.flagship:
        kw.update(FLAGSHIP)
    return Options(gold_score_mode="jsa", n_context=args.n_context,
                   mis_step=args.mis, per_gpu_batch_size=args.batch,
                   train_retriever=True, use_all_mis=True,
                   unil_postandprior=True, seed=args.seed,
                   device=args.device, **kw)


def random_index(n: int, dim: int, storage: str, dev: torch.device,
                 seed: int) -> ShardedFlatIndex:
    """A flat index of ``storage`` holding seeded random unit rows, written
    ``CHUNK`` rows at a time through the index's own encoder."""
    index = ShardedFlatIndex(n, dim, storage, device=dev)
    make = unit_gaussian(dim, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for lo in range(0, n, CHUNK):
        index.set_embeddings(lo, make(g, min(CHUNK, n - lo)))
    return index


def median_ms(xs) -> float:
    return float(statistics.median(xs)) if xs else float("nan")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--size", default="base")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mis", type=int, default=50)
    ap.add_argument("--n_context", type=int, default=10)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--text_maxlength", type=int, default=256)
    ap.add_argument("--flagship", action="store_true",
                    help="the reference flagship's training flags (module "
                    "docstring); with --n 1300000 its full profile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    opt = bench_options(args)
    t0 = time.perf_counter()
    store = uniform_passages(args.n, seed=args.seed)
    model, params, _ = load_or_initialize_model(opt, store)
    dim = model.retriever.cfg.bert.hidden
    storage = "hybrid" if args.flagship else "float16"
    index = random_index(len(store), dim, storage, dev, args.seed + 1)
    tx = set_optim(opt, params)
    train_step = make_train_step(model, "jsa", tx)
    rng = StepRng.from_seed(args.seed, dev)
    print(f"# setup {time.perf_counter() - t0:.1f} s: {opt.model_size} "
          f"geometry, {storage} index, n={args.n}, B={args.batch}, "
          f"mis={args.mis}, K={args.n_context}, L={opt.text_maxlength}",
          flush=True)

    # the update's device span, inside the step's
    update = Span(dev)
    real_update = tx.step

    def timed_update(grads):
        update.start()
        done = real_update(grads)
        update.stop()
        return done

    tx.step = timed_update
    step_span = Span(dev)
    words = np.random.default_rng(args.seed)
    rows = {k: [] for k in ("batch_ms", "step_ms", "step_device_ms",
                            "grad_device_ms", "update_device_ms")}
    losses = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    for step in range(args.steps + WARMUP):
        queries = [f"what is w{words.integers(900)} q{step} b{i}"
                   for i in range(args.batch)]
        targets = [f"w{words.integers(900)}" for _ in range(args.batch)]
        t0 = time.perf_counter()
        batch = model.build_batch("jsa", index, params, queries, targets)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        step_span.start()
        loss, _ = train_step(params, batch, rng)
        step_span.stop()
        loss = float(loss)  # waits for the step
        t2 = time.perf_counter()
        if not np.isfinite(loss):
            raise FloatingPointError(f"step {step}: loss {loss}")
        losses.append(loss)
        if step < WARMUP:
            continue
        step_ms, update_ms = step_span.ms(), update.ms()
        for key, v in (("batch_ms", (t1 - t0) * 1e3),
                       ("step_ms", (t2 - t1) * 1e3),
                       ("step_device_ms", step_ms),
                       ("grad_device_ms", step_ms - update_ms),
                       ("update_device_ms", update_ms)):
            rows[key].append(v)
    med = {k: median_ms(v) for k, v in rows.items()}
    step_s = (med["batch_ms"] + med["step_ms"]) / 1e3
    result = {
        **platform_of(dev), "size": opt.model_size,
        "flagship": args.flagship, "storage": storage, "n": args.n,
        "batch": args.batch, "mis": args.mis, "n_context": args.n_context,
        "text_maxlength": opt.text_maxlength, "steps": args.steps,
        "per_step": rows, "median": med, "losses": losses,
        "examples_per_s": args.batch / step_s,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}
    for k in ("batch_ms", "step_ms", "step_device_ms", "grad_device_ms",
              "update_device_ms"):
        print(f"{k:17s} median {med[k]:9.1f}  per step "
              + " ".join(f"{v:.1f}" for v in rows[k]), flush=True)
    print(f"step total {step_s * 1e3:.1f} ms -> "
          f"{result['examples_per_s']:.2f} examples/s", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
