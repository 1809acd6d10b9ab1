"""What the DeepSeek-V2 training cell adds, at a toy size on the CPU
(``tiny_moe.py``): its counted share reads, its expert work counts the
profiled steps only and equals a count by hand, and the readings that set
its limits run. Its toy run, traced run, faults and control are
``test_bench_cells.py``'s cases, as every cell's (``conftest.py`` enters
the cell there)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny_moe import GENERATOR, OVERRIDES
from benchmark.yardstick import flops_mla_moe

MAN = harness.manifest()
SEED = 2 ** 31 + 99
CPU = torch.device("cpu")
MOE = "train-jsa-dsv2lite"


def run(w: str, trace: bool = False, seconds: float = 0.5) -> dict:
    return harness.run_cell(MAN, w, SEED, seconds, trace, CPU, OVERRIDES[w])


def test_a_traced_toy_moe_run_reads_its_counted_share():
    r = run(MOE, trace=True)
    assert r["correct"], r["checks"]
    assert r["checks"]["route_faults"]["value"] == 0
    # the CPU has no device trace: the counted share reads
    assert "train_moe.mfu" in r["metrics"]


def test_the_expert_work_counts_the_profiled_steps_only():
    """The roofline's bound is the work of the steps the profiler traced
    (``trace_steps``), not of the window's other steps."""
    from benchmark.drivers import train_jsa_moe as drv

    ov = OVERRIDES[MOE]
    entry, config, traffic, limits = harness.cell_files(MAN, MOE)
    ctx = harness.Ctx(entry, {**config, **ov["config"]},
                      {**traffic, **ov["traffic"], "trace_after_s": 0.3},
                      {**limits, **ov["limits"]}, SEED, CPU, True)
    state = drv.setup(ctx)
    win = drv.window(state, 1.5, True)
    drv.release(state)
    assert win.counters["traced_steps"] == ctx.traffic["trace_steps"]
    assert win.attempted > win.counters["traced_steps"]


def test_mla_moe_work_by_hand():
    c = GENERATOR  # H 64, 4 heads, nope 16 / rope 8 / v 16, latent 32
    # q 64x96, kv_a 64x40, kv_b 32x128, o 64x64
    assert flops_mla_moe.mla_params(c) == 6144 + 2560 + 4096 + 4096
    t, lab = 5, 2
    attn = 4 * (16 + 8 + 16) * t * (t + 1)
    assert flops_mla_moe.attention_flops(c, t) == attn
    dense = 6 * 64 * 128 * t  # layer 0
    moe = (2 * 64 * 8 + 2 * 6 * 64 * 32 + 6 * 64 * 32) * t  # layers 1, 2
    head = 2 * 64 * 600 * lab
    fwd = 3 * (2 * 16896 * t + attn) + dense + 2 * moe + head
    assert flops_mla_moe.forward_flops(c, t, lab) == fwd
    r = 3
    per_tok = 2 * r * (3 * ((64 + 96) + (64 + 64)) + 3 * (64 + 128)
                       + 2 * (3 * (64 + 32) + 2 * 3 * (64 + 32)))
    assert flops_mla_moe.lora_forward_flops(c, r, t) == per_tok * t
    assert flops_mla_moe.train_flops(c, r, t, lab) == \
        fwd + (fwd + 3 * attn) + 3 * per_tok * t
    ops, n_bytes = flops_mla_moe.expert_work(c, r, t)
    n = 2 * t  # rows in the groups
    assert ops == 2 * (3 * 6 * n * 64 * 32 + 4 * 6 * n * r * (64 + 32))
    weights = 2 * 3 * 8 * 64 * 32 + 2 * 3 * 8 * r * (64 + 32)
    rows = 2 * 3 * n * (64 + 32) + 2 * 3 * n * (64 + 32 + 2 * r)
    assert n_bytes == 2 * 3 * (weights + rows)


@pytest.mark.parametrize("variant", ["sound", "control"])
def test_the_limit_readings_run_at_a_toy_size(variant):
    """``controls_moe.py``'s readings: the sound run's experts differ from
    the f32 reference's nowhere at float32 on both sides; the control's
    do."""
    from benchmark import controls_moe

    entry, config, traffic, limits = harness.cell_files(MAN, MOE)
    ov = OVERRIDES[MOE]
    ctx = harness.Ctx(entry, {**config, **ov["config"]},
                      {**traffic, **ov["traffic"]},
                      {**limits, **ov["limits"]}, SEED, CPU, False)
    out = controls_moe.readings(ctx, variant)
    assert out["pairs"] > 0
    assert (out["differ"] == 0) == (variant == "sound")
