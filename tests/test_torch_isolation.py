"""The port stands alone: no JAX and nothing of the JAX package in
``jsa_rag_tpu_torch/`` or ``chip_smoke.py``; the CUDA kernel never launches
for CPU tensors; a request for CUDA where there is none raises; the smoke
fails without a card or without the repository."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jsa_rag_tpu_torch
from jsa_rag_tpu_torch.device import resolve_device
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
from jsa_rag_tpu_torch.models import (BertConfig, DualEncoderRetriever,
                                      RetrieverConfig)
from jsa_rag_tpu_torch.ops import mips_topt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "jsa_rag_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "jsa_rag_tpu", "flax", "optax"}


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_jax_imports_in_port_sources():
    sources = _sources()
    assert len(sources) > 15
    for path in sources:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Every module of the package imports in a process where ``import
    jax`` and ``import jsa_rag_tpu`` fail."""
    names = [m.name for m in pkgutil.walk_packages(
        jsa_rag_tpu_torch.__path__, "jsa_rag_tpu_torch.")]
    assert "jsa_rag_tpu_torch.serve.__main__" in names
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'jsa_rag_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m.startswith(('jax.', 'jsa_rag_tpu.'))\n"
            "               for m in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cpu_search_never_launches_the_kernel():
    launches = mips_topt.scan_topt_int8r2.launches
    if not torch.cuda.is_available():
        assert launches == 0  # nothing in this process can launch it
    idx = ShardedFlatIndex(300, 16, device="cpu")
    rng = np.random.default_rng(0)
    idx.set_embeddings(0, rng.standard_normal((300, 16)).astype(np.float32))
    s, i = idx.search(rng.standard_normal((3, 16)).astype(np.float32), 5)
    assert s.device.type == "cpu" and i.shape == (3, 5)
    assert mips_topt.scan_topt_int8r2.launches == launches


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedFlatIndex(10, 8)  # the default device is cuda
    cfg = RetrieverConfig(bert=BertConfig(vocab_size=10, hidden=8, layers=1,
                                          heads=2, intermediate=8))
    with pytest.raises(RuntimeError, match="cuda"):
        DualEncoderRetriever(cfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_refuses_what_it_cannot_take():
    q = torch.zeros((2, 16), dtype=torch.int8)
    qs = torch.ones((2, 1))
    e = torch.zeros((64, 16), dtype=torch.int8)
    es = torch.ones((1, 64))
    with pytest.raises(TypeError):
        mips_topt.scan_topt_int8r2(q.float(), qs, q, qs, e, es, 64, 128, 4)
    with pytest.raises(ValueError):
        mips_topt.scan_topt_int8r2(q, qs, q, qs, e, es, 65, 128, 4)
    with pytest.raises(ValueError):
        mips_topt.scan_topt_int8r2(q, qs, q, qs, e.t().contiguous().t(),
                                   es, 64, 128, 4)  # not contiguous
    with pytest.raises(ValueError):
        mips_topt.scan_topt_int8r2(q, qs, q, qs, e, es, 64, 128, 129)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    """No CUDA here: the smoke exits non-zero and prints no result line;
    copied into a directory without the repository it fails as well."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
