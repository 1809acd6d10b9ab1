"""Readings of the controls and the planted faults at a cell's own size,
for setting the limits of ``limits/<workload>.json`` (steps 2-4 of how
``correct`` is decided). The benchmark's own runs never run this.

    python3 benchmark/controls.py --workload <name> --seeds 11,12,13 \\
        --variant control|<fault> [--seconds 4]

The control is the computation one step below the configuration's
precision, put in the program's place: for a search, the program's own
int8 storage (one plane, no refine) in place of int8r; for a rebuild, the
reference's tower with fp8 products (the recipe states bf16); for
training, the reference with fp8 products in the generator and the towers
(bf16 stated), followed by the float32 reference as a run is. A fault
(``faults.py``) is planted under a whole run. Prints one JSON line a seed:
the compared numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(ctx) -> dict:
    """The control's compared numbers for one seed."""
    import numpy as np

    from benchmark import harness, inputs
    from benchmark.drivers import rebuild, train_jsa
    from benchmark.reference import jsa as ref_jsa
    from benchmark.reference.precision import Matmul

    kind = ctx.traffic["driver"]
    if kind == "search":
        idx = dict(ctx.config["index"], dtype="int8")
        man = harness.manifest()
        r = harness.run_cell(man, ctx.workload["name"], ctx.seed, 4.0, False,
                             ctx.device, {"config": {"index": idx},
                                          "traffic": ctx.traffic})
        return {n: c["value"] for n, c in r["checks"].items()}
    if kind == "rebuild":
        n = int(ctx.config["index"]["rows"])
        rng = np.random.default_rng(inputs.derive_seed(ctx.seed, "judge"))
        ids = np.sort(rng.choice(n, size=int(ctx.traffic["sample_rows"]),
                                 replace=False))
        outs = {"written": ids, "written_rows": rebuild.reference_rows(
                    ctx, ids, Matmul("fp8")).cpu().numpy()}
        return rebuild.compare(ctx, outs, Matmul("f32"))
    if kind == "train_jsa":
        qs = [train_jsa.qa_batch(ctx, s) for s in
              range(int(ctx.traffic["judged_steps"]))]
        qs = [(q[0], a[0]) for q, a in qs]
        ctrl = ref_jsa.run(ctx, qs, gen_kind="fp8", tower_kind="fp8")
        harness.free(ctx.device)
        judge = ref_jsa.run(ctx, qs, follow=ctrl)
        return train_jsa.compare(ctrl, judge, {**ctx.config["recipe"],
                                               **ctx.traffic["options"]})
    raise ValueError(kind)


def fault_numbers(ctx, fault: str, seconds: float) -> dict:
    from benchmark import faults, harness

    plant, kinds = faults.FAULTS[ctx.traffic["driver"]]
    if fault not in kinds:
        raise ValueError(f"{fault!r} is not a fault of this cell: {kinds}")
    with plant(fault):
        r = harness.run_cell(harness.manifest(), ctx.workload["name"],
                             ctx.seed, seconds, False, ctx.device,
                             {"config": ctx.config, "traffic": ctx.traffic})
    return {n: c["value"] for n, c in r["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    dev = torch.device(args.device)
    man = harness.manifest()
    w, config, traffic, limits = harness.cell_files(man, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(w, config, traffic, limits, seed, dev, False)
        if args.variant == "control":
            nums = control_numbers(ctx)
        else:
            nums = fault_numbers(ctx, args.variant, args.seconds)
        harness.free(dev)
        print(json.dumps({"workload": args.workload, "variant": args.variant,
                          "seed": seed, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
