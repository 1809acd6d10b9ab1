"""The port stands alone: no JAX and nothing of the JAX package in
``jsa_rag_tpu_torch/`` or ``chip_smoke.py``, and no ``transformers``,
``safetensors`` or ``ml_dtypes`` (the card has none of them) apart from the
tokenizer loader's guarded import; the HF directory reader works with those
three blocked; the CUDA kernel never launches for CPU tensors; a request for
CUDA where there is none raises; the smoke fails without a card or without
the repository."""

import ast
import json
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
HF_PACKAGES = {"transformers", "safetensors", "ml_dtypes"}
# the one guarded import: HF tokenizers where a model directory has one
# (data/tokenizer.py::load_tokenizer), as the JAX package loads them
GUARDED = {os.path.join(PKG, "data", "tokenizer.py"): {"transformers"}}


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


def _module_level_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    body = ast.Module(body=[n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.If, ast.Try, ast.With))],
        type_ignores=[])
    roots = set()
    for node in ast.walk(body):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_hf_packages_in_port_sources():
    """No port module and not the smoke imports transformers, safetensors
    or ml_dtypes; the tokenizer loader imports transformers inside its
    function only."""
    for path in _sources():
        allowed = GUARDED.get(path, set())
        bad = (_imported_roots(path) & HF_PACKAGES) - allowed
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
        assert not _module_level_roots(path) & HF_PACKAGES, path


def test_hf_loader_works_with_hf_packages_blocked(tmp_path):
    """HF directories (bge safetensors, a sharded mistral, a gpt2
    ``pytorch_model.bin``) load through ``load_or_initialize_model`` in a
    process where transformers, safetensors, ml_dtypes and jax cannot be
    imported, as on the card, to the same leaves as here."""
    transformers = pytest.importorskip("transformers")
    from jsa_rag_tpu_torch import convert, model_io
    from jsa_rag_tpu_torch.config import Options
    from jsa_rag_tpu_torch.data.passages import PassageStore

    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=50, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32)).save_pretrained(str(tmp_path / "bge"))
    transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=40, hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        tie_word_embeddings=False)).save_pretrained(
            str(tmp_path / "mistral"), max_shard_size="8KB")
    transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=40, n_embd=16, n_layer=1, n_head=2,
        n_positions=32)).save_pretrained(str(tmp_path / "gpt2"),
                                         safe_serialization=False)
    for gen in ("mistral", "gpt2"):
        argv = ["--device", "cpu", "--retriever_model_path",
                str(tmp_path / "bge"), "--generator_model_path",
                str(tmp_path / gen), "--generator_model_type", gen,
                "--max_vocab", "40", "--use_lora", "false",
                "--param_dtype", "bfloat16"]
        _, params, _ = model_io.load_or_initialize_model(
            Options.from_args(argv), PassageStore.synthetic(4))
        want = {k: float(v.sum()) for k, v in convert.params_to_numpy(
            params)["generator"]["layers"][0].items()}
        code = ("import sys, json\n"
                "for m in ('transformers', 'safetensors', 'ml_dtypes', "
                "'jax', 'jaxlib', 'jsa_rag_tpu'):\n"
                "    sys.modules[m] = None\n"
                "from jsa_rag_tpu_torch import convert, model_io\n"
                "from jsa_rag_tpu_torch.config import Options\n"
                "from jsa_rag_tpu_torch.data.passages import PassageStore\n"
                f"opt = Options.from_args({argv!r})\n"
                "_, p, _ = model_io.load_or_initialize_model(\n"
                "    opt, PassageStore.synthetic(4))\n"
                "layer = convert.params_to_numpy(p)['generator']['layers'][0]\n"
                "print(json.dumps({k: float(v.sum()) for k, v in "
                "layer.items()}))\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.strip().splitlines()[-1]) == want


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
    idx = ShardedFlatIndex(300, 16, "int8r", device="cpu")
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


@pytest.mark.parametrize("storage", ["int8", "hybrid", "int8r-rows1",
                                     "int8r-cols"])
def test_cpu_int8_searches_never_launch_b2(storage):
    """Every storage behind kernel B2 runs its plain version on the CPU."""
    launches = mips_topt.scan_topt_int8.launches
    dtype, _, refine = storage.partition("-")
    idx = ShardedFlatIndex(300, 16, dtype, device="cpu",
                           int8r_refine=refine or "rows")
    rng = np.random.default_rng(0)
    idx.set_embeddings(0, rng.standard_normal((300, 16)).astype(np.float32))
    s, i = idx.search(rng.standard_normal((3, 16)).astype(np.float32), 5)
    assert s.device.type == "cpu" and i.shape == (3, 5)
    assert mips_topt.scan_topt_int8.launches == launches


@pytest.mark.parametrize("search", ["pallas2", "pallas", "float16",
                                    "int8", "bench", "storage-bench"])
def test_cpu_row_searches_never_launch_b6_to_b9(search):
    """The row-major wrappers of kernels B6-B9, and both benches, run their
    plain versions on the CPU: no counter moves."""
    from jsa_rag_tpu_torch import bench
    from jsa_rag_tpu_torch.analysis import storage_recall_bench
    from jsa_rag_tpu_torch.ops import mips, mips_stream

    counters = (mips_topt.mips_topk_dense, mips_topt.mips_topk_f16,
                mips_topt.mips_topk_int8, mips_stream.mips_topk_stream)
    before = [c.launches for c in counters]
    if not torch.cuda.is_available():
        assert before == [0, 0, 0, 0]
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    e /= e.norm(dim=1, keepdim=True)
    q = e[:3].clone()
    if search in ("pallas2", "pallas"):
        _, i = mips.mips_topk(q, e, 5, method=search)
    elif search == "float16":
        _, i = mips.mips_topk(q, e.half(), 5)
    elif search == "int8":
        _, i = mips_topt.mips_topk_int8(q, *mips_topt.quantize_int8(e), 5)
    if search == "bench":
        for method in ("pallas2", "pallas"):
            bench.main(["--device", "cpu", "--n", "300", "--d", "16",
                        "--b", "3", "--k", "5", "--iters", "2", "--method",
                        method])
    elif search == "storage-bench":
        storage_recall_bench.main([
            "--device", "cpu", "--n", "300", "--d", "16", "--b", "3",
            "--k", "20", "--iters", "1", "--clusters", "8", "--modes",
            "bf16_row,f16_row,int8"])
    else:
        assert i[:, 0].tolist() == [0, 1, 2]
    assert [c.launches for c in counters] == before


def test_int8_wrapper_refuses_what_it_cannot_take():
    q = torch.zeros((2, 16), dtype=torch.int8)
    qs = torch.ones((2, 1))
    e = torch.zeros((64, 16), dtype=torch.int8)
    es = torch.ones((1, 64))
    with pytest.raises(TypeError):
        mips_topt.scan_topt_int8(q.float(), qs, e, es, 64, 128, 4)
    with pytest.raises(ValueError):
        mips_topt.scan_topt_int8(q, qs, e, es, 65, 128, 4)
    with pytest.raises(ValueError):
        mips_topt.scan_topt_int8(q, qs, e.t().contiguous().t(), es, 64, 128,
                                 4)  # not contiguous
    with pytest.raises(ValueError):
        mips_topt.scan_topt_int8(q, qs, e, es, 64, 128, 129)
    with pytest.raises(ValueError, match="refine"):
        mips_topt.mips_topk_int8_t(q.float(), e, es, 4, refine=2)


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
