"""One short run of each cell on the card, through the command; skips
where there is no card (decided inside the test)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("w", [w["name"] for w in
                               harness.manifest()["workloads"]])
def test_a_short_run_on_the_card_is_correct(w):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs only on the card")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.ROOT, "benchmark", "run.py"),
         "--workload", w, "--seed", str(2 ** 31 + 5), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
