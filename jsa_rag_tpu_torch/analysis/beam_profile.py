"""Where a beam search's decode time goes, at ``egs/eval.sh``'s shape.

    python -m jsa_rag_tpu_torch.analysis.beam_profile [layers] [steps]

A generator at Mistral-7B-v0.1's widths (``LMConfig``'s defaults) with
``layers`` layers (default 8), N(0, 0.02) weights from seed 0 stored in
bf16, 80 seeded left-padded prompts of up to 72 ids (a batch of 8
questions x 10 passages), 4 beams, length penalty 1.1 and no EOS, so every
one of ``steps`` (default 256) decode steps runs. Prints one JSON line:
the search's device time (CUDA events) and wall time, then the same search
cut to 32 steps under ``torch.profiler``: the device's busy share (the
union of its kernel intervals over the window), the kernel launches a
step, and the ops that take the most device time and host time.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from jsa_rag_tpu_torch.device import exact_f32_matmul
from jsa_rag_tpu_torch.models.lm import LMConfig, beam_generate, lm_init

ROWS, PROMPT, BEAMS, PROFILED_STEPS = 80, 72, 4, 32


def _busy_share(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / (spans[-1][1] - spans[0][0])


def profile(layers: int, steps: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(0)
    cfg = LMConfig(layers=layers)
    params = lm_init(cfg, device=device, generator=g)
    params = {k: (v.to(torch.bfloat16) if torch.is_tensor(v) else
                  [{n: w.to(torch.bfloat16) for n, w in layer.items()}
                   for layer in v]) for k, v in params.items()}
    ids = torch.randint(3, cfg.vocab_size, (ROWS, PROMPT), generator=g,
                        device=device)
    mask = torch.ones_like(ids)
    for r in range(ROWS):
        mask[r, :r % 40] = 0
        ids[r, :r % 40] = 0

    def run(n):
        return beam_generate(params, cfg, ids, mask, max_new_tokens=n,
                             eos_id=-1, pad_id=0, num_beams=BEAMS,
                             length_penalty=1.1)

    run(4)  # first-use costs out of the timed runs
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(steps)
    stop.record()
    stop.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(PROFILED_STEPS)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in events)
    avg = prof.key_averages()

    def top(key):
        rows = sorted(avg, key=lambda e: -getattr(e, key))[:8]
        return [(e.key, round(getattr(e, key) / 1e3, 3)) for e in rows]

    return {"layers": layers, "steps": steps, "rows": ROWS, "beams": BEAMS,
            "device_ms": start.elapsed_time(stop), "wall_ms": wall * 1e3,
            "profiled_steps": PROFILED_STEPS,
            "device_busy_share": _busy_share(events),
            "kernels_a_step": kernels / PROFILED_STEPS,
            "top_device_ms": top("self_device_time_total"),
            "top_host_ms": top("self_cpu_time_total")}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    layers = int(argv[0]) if argv else 8
    steps = int(argv[1]) if len(argv) > 1 else 256
    exact_f32_matmul()
    print(json.dumps(profile(layers, steps, torch.device("cuda", 0))),
          flush=True)


if __name__ == "__main__":
    main()
