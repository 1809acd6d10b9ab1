"""Readings for setting ``limits/train-jsa-dsv2lite.json``, as ``controls.py``
gives the other cells' (the benchmark's own runs never run this):

    python3 benchmark/controls_moe.py --seeds 11,12,13 --variant sound|control

``sound``: the program's judged steps (the cell's set-up) against the f32
reference; ``control``: the reference with fp8 products in the generator
and the towers in the program's place. Both are followed by the f32
reference with no router margin, which also gives, over every real (token,
MoE layer), its gap between the 6th and 7th router probabilities
(``drivers/train_jsa_moe.py::route_gaps``). Prints one JSON line a seed:
the compared numbers, the largest gap at which the experts differ, and how
many differ above each of ``MARGINS`` (and what share of all pairs lies
above it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WORKLOAD = "train-jsa-dsv2lite"
MARGINS = (1e-3, 2e-3, 3e-3, 5e-3, 7e-3, 1e-2, 1.2e-2, 1.5e-2, 2e-2)


def readings(ctx, variant: str) -> dict:
    import numpy as np

    from benchmark import harness
    from benchmark.drivers import train_jsa_moe as drv
    from benchmark.reference import jsa_moe as ref_moe

    if variant == "sound":
        state = drv.setup(ctx)
        outs = drv.outputs(state)
        drv.release(state)
        del state
    else:
        qs = [drv.train_jsa.qa_batch(ctx, s)
              for s in range(int(ctx.traffic["judged_steps"]))]
        outs = ref_moe.run(ctx, [(q[0], a[0]) for q, a in qs],
                           gen_kind="fp8", tower_kind="fp8")
    harness.free(ctx.device)
    ref, bad, every = drv.route_gaps(ctx, outs)
    nums = drv.compare(outs, ref, {**ctx.config["recipe"],
                                   **ctx.traffic["options"]})
    nums.pop("route_faults")  # counted below at each margin
    return {"numbers": nums,
            "differ_max_gap": float(bad.max()) if len(bad) else 0.0,
            "differ": int(len(bad)), "pairs": int(len(every)),
            "differ_above": {str(m): int((bad > m).sum()) for m in MARGINS},
            "share_above": {str(m): float((every > m).mean())
                            for m in MARGINS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", choices=("sound", "control"),
                    required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    man = harness.manifest()
    w, config, traffic, limits = harness.cell_files(man, WORKLOAD)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(w, config, traffic, limits, seed, dev, False)
        out = readings(ctx, args.variant)
        harness.free(dev)
        print(json.dumps({"workload": WORKLOAD, "variant": args.variant,
                          "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
