"""Each cell's whole run at a toy size on the CPU (the kernels' plain
versions): a sound run is correct; a run with a fault planted underneath,
and the control in the program's place, are not."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from benchmark import controls, faults, harness
from benchmark.tests.tiny import OVERRIDES

MAN = harness.manifest()
SEED = 2 ** 31 + 99  # more than 32 signed bits hold
CELLS = [w["name"] for w in MAN["workloads"]]
CPU = torch.device("cpu")


def _driver(w: str) -> str:
    return harness.cell_files(MAN, w)[2]["driver"]


def run(w: str, trace: bool = False, seed: int = SEED) -> dict:
    return harness.run_cell(MAN, w, seed, 0.5, trace, CPU, OVERRIDES[w])


@pytest.mark.parametrize("w", CELLS)
def test_a_toy_run_is_correct_and_reports_its_metrics(w):
    r = run(w)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in harness.end_to_end_of(MAN, w)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("w", CELLS)
def test_a_traced_toy_run_reads_its_counted_layers(w):
    r = run(w, trace=True)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in harness.per_layer_of(MAN, w)}
    assert set(r["metrics"]) <= names
    # the CPU has no device trace: only the counted metrics read
    assert not any(n.startswith("device_idle") for n in r["metrics"])
    assert "breakdown" in r and "busy_s" in r["device"]


@pytest.mark.parametrize("w,fault", [
    (w, f) for w in CELLS for f in faults.FAULTS[
        harness.cell_files(MAN, w)[2]["driver"]][1]])
def test_a_fault_under_the_run_makes_it_incorrect(w, fault):
    plant, _ = faults.FAULTS[_driver(w)]
    with plant(fault):
        r = run(w)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("w", CELLS)
def test_the_control_fails_the_comparison(w):
    entry, config, traffic, limits = harness.cell_files(MAN, w)
    ov = OVERRIDES[w]
    limits = {**limits, **ov.get("limits", {})}
    ctx = harness.Ctx(entry, {**config, **ov["config"]},
                      {**traffic, **ov["traffic"]}, limits, SEED, CPU, False)
    nums = controls.control_numbers(ctx)
    checks = harness.checks_against(limits, nums)
    assert not all(c.ok for c in checks), nums


def test_the_command_refuses_without_a_card():
    root = harness.ROOT
    out = subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_reference_chain_draws_what_the_programs_chain_draws():
    """The stage the training reference follows the run through (its
    chain samples) held by itself: the recipe's chain as the reference
    writes it against the program's, on the same proposals and uniforms."""
    import numpy as np

    from benchmark.reference import jsa as ref_jsa
    from jsa_rag_tpu_torch.train.modes import (draw_mis,
                                               empirical_distribution,
                                               mis_chain)

    g = torch.Generator().manual_seed(7)
    for _ in range(20):
        u = 20
        post = torch.softmax(torch.randn(1, u, generator=g) * 3, -1)
        prior = torch.softmax(torch.randn(1, u, generator=g) * 3, -1)
        lm = -torch.rand(1, u, generator=g) * 12
        props, unif = draw_mis(g, post, 50)
        sampled, _, _ = mis_chain(post, prior, lm, props, unif)
        mine, _ = ref_jsa.chain(post[0].double().numpy(),
                                prior[0].double().numpy(),
                                lm[0].double().numpy(), props[:, 0].numpy(),
                                unif[:, 0].double().numpy(), 1.0, 1e-30)
        assert np.array_equal(sampled[:, 0].numpy(), np.asarray(mine))
        emp = empirical_distribution(sampled, u)[0].numpy()
        assert np.allclose(emp, np.bincount(mine, minlength=u) / 50)
