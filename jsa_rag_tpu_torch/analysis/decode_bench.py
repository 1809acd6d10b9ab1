"""Autoregressive decode throughput, the eval harness's hot path
(counterpart of ``scripts/analysis/decode_bench.py``).

The reference decodes up to 256 new tokens an example with HF ``generate``
(evaluate.py:251 greedy; src/rag.py:2247-2258 beam). This times the port's
KV-cache decode, ``models/lm.py::greedy_generate`` and ``beam_generate``
(``--beams`` beams, length penalty 1.1), at a llama geometry (``--layers``
x ``--hidden``, head dim 128, ``--kv_heads``, FFN 3.5 x hidden, bf16,
weights from ``--seed``) on prompts of ``--prompt`` tokens (the
concat-10-passages eval prompt) at each batch of ``--batches``: the wall
time of a call (host clock around a call that ends in a synchronise;
the decode is launched op by op, so the host is part of it), its ms a
token, tokens/s (batch x ``--new`` over the call), and the decode steps
it ran (the one-token forwards). Then the early-exit arm: EOS set to the
token this model emits most, so rows finish within a few steps (the
short-answer QA regime) and the loop's exit, not the budget, sets the
time::

    python -m jsa_rag_tpu_torch.analysis.decode_bench
    python -m jsa_rag_tpu_torch.analysis.decode_bench --new 64 --batches 8
    python -m jsa_rag_tpu_torch.analysis.decode_bench --device cpu \\
        --layers 2 --hidden 256 --kv_heads 1 --vocab 512 --prompt 16 \\
        --new 8 --batches 1,2 --beams 2

Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from ..bench import platform_of
from ..device import resolve_device
from ..models import lm
from ..train.optim import named_leaves

EOS, PAD = 2, 0


@contextlib.contextmanager
def counted_steps():
    """Count the one-token decode forwards run in the block (greedy's
    ``_forward_with_cache`` on one token, beam's ``_beam_decode_forward``);
    yields a dict whose ``steps`` grows."""
    counts = {"steps": 0}
    real_cached, real_beam = lm._forward_with_cache, lm._beam_decode_forward

    def cached(p, cfg, input_ids, *args, **kwargs):
        counts["steps"] += int(input_ids.shape[1] == 1)
        return real_cached(p, cfg, input_ids, *args, **kwargs)

    def beam(*args, **kwargs):
        counts["steps"] += 1
        return real_beam(*args, **kwargs)

    lm._forward_with_cache, lm._beam_decode_forward = cached, beam
    try:
        yield counts
    finally:
        lm._forward_with_cache, lm._beam_decode_forward = (real_cached,
                                                           real_beam)


def timed_call(fn, dev: torch.device, iters: int):
    """(mean wall seconds a call over ``iters`` calls after one warm call,
    the last output, decode steps a call)."""
    out = fn()
    with counted_steps() as counts:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = (time.perf_counter() - t0) / iters
    return seconds, out, counts["steps"] / iters


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--kv_heads", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--new", type=int, default=256)
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--beams", type=int, default=4)
    ap.add_argument("--iters", type=int, default=2,
                    help="timed calls an arm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    heads = args.hidden // 128
    cfg = lm.LMConfig(vocab_size=args.vocab, hidden=args.hidden,
                      layers=args.layers, heads=heads,
                      kv_heads=min(args.kv_heads, heads),
                      intermediate=int(3.5 * args.hidden),
                      dtype=torch.bfloat16)
    params = lm.lm_init(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    n_params = sum(t.numel()
                   for t in named_leaves({"generator": params}).values())
    print(f"# {platform_of(dev)} {args.layers}x{args.hidden} "
          f"(kv={cfg.kv_heads}) = {n_params / 1e9:.2f}B params, "
          f"prompt={args.prompt} new={args.new}", flush=True)
    rows = []

    def arm(name: str, b: int, fn) -> np.ndarray:
        seconds, out, steps = timed_call(fn, dev, args.iters)
        out = out.cpu().numpy()
        row = {"arm": name, "batch": b, "ms": seconds * 1e3,
               "ms_per_token": seconds * 1e3 / args.new,
               "tokens_per_s": b * args.new / seconds,
               "decode_steps": steps,
               "emitted_mean": float((out != PAD).sum(-1).mean())}
        rows.append(row)
        print(f"B={b:3d} {name:16s}: {row['ms']:9.1f} ms "
              f"({row['ms_per_token']:6.2f} ms/tok) -> "
              f"{row['tokens_per_s']:8.0f} tok/s, {steps:g} decode steps, "
              f"{row['emitted_mean']:.1f} emitted", flush=True)
        return out

    for b in (int(x) for x in args.batches.split(",")):
        ids = torch.full((b, args.prompt), 7, dtype=torch.long, device=dev)
        mask = torch.ones((b, args.prompt), dtype=torch.long, device=dev)

        def greedy(eos=EOS):
            return lm.greedy_generate(params, cfg, ids, mask,
                                      max_new_tokens=args.new, eos_id=eos,
                                      pad_id=PAD)

        sample = arm("greedy", b, greedy)
        arm(f"beam{args.beams}", b, lambda: lm.beam_generate(
            params, cfg, ids, mask, max_new_tokens=args.new, eos_id=EOS,
            pad_id=PAD, num_beams=args.beams, length_penalty=1.1))
        vals, counts = np.unique(sample[sample != PAD], return_counts=True)
        eos_fast = int(vals[np.argmax(counts)])
        arm("greedy-earlyexit", b, lambda: greedy(eos_fast))
    result = {**platform_of(dev), "layers": args.layers,
              "hidden": args.hidden, "kv_heads": cfg.kv_heads,
              "vocab": args.vocab, "prompt": args.prompt, "new": args.new,
              "beams": args.beams, "params": n_params, "arms": rows}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
