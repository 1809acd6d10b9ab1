"""Port parity of the export and recall functions the script tools call
(ROADMAP A16), against the JAX package on the same inputs:
``lora_merge_export``, ``recall_at_k`` and ``mrr_at_k``, and the two
analysis entry points (``jsa_rag_tpu_torch.analysis.extract_towers`` and
``recall_mrr``) against ``scripts/analysis/`` on a tiny checkpoint."""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu import model_io as jmodel_io
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.models import lm as jlm
from jsa_rag_tpu.models import lora as jlora
from jsa_rag_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from jsa_rag_tpu.utils import metrics as jmetrics
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch.analysis import extract_towers, recall_mrr
from jsa_rag_tpu_torch.models import lora as tlora
from jsa_rag_tpu_torch.utils import metrics as tmetrics

from test_torch_train import _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts", "analysis"))

import extract_towers as jextract  # noqa: E402
import recall_mrr as jrecall_mrr  # noqa: E402


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_lora_merge_export_matches_jax(arch):
    """The merged tree of non-zero adapters at rank 4, alpha 8, leaf for
    leaf within 1e-6; every leaf a plain copy the adapters reach no more
    (the base's gradient flows, as under ``train_base``)."""
    cfg = jlm.LMConfig(vocab_size=64, hidden=32, layers=2, heads=4,
                       kv_heads=4 if arch == "gpt2" else 2, intermediate=48,
                       dtype=jnp.float32, arch=arch, max_positions=16)
    params = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0)
    lora = jlora.lora_init(jax.random.PRNGKey(1), params, lcfg)
    rng = np.random.default_rng(2)
    lora = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                              jnp.float32), lora)
    want = _flat(jax.tree_util.tree_map(
        np.asarray, jlora.lora_merge_export(params, lora, lcfg)))
    tparams = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params))
    for leaf in jax.tree_util.tree_leaves(tparams):
        leaf.requires_grad_(True)
    tlora_tree = convert.lora_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, lora))
    merged = tlora.lora_merge_export(
        tparams, tlora_tree, tlora.LoRAConfig(rank=4, alpha=8.0))
    got = _flat(convert.lm_params_to_numpy(merged))
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=0, atol=1e-6,
                                   err_msg=str(path))
    assert merged["layers"][0]["o_w"].requires_grad
    assert merged["embed"].requires_grad


RANKINGS = [([3, 9, 1, 4], {1}), ([3, 9, 1, 4], {7}), ([5], {5}),
            ([], {2}), (["a", "b", "c"], {"c", "b"}),
            (list(range(20)), {15})]


@pytest.mark.parametrize("ranked,gold", RANKINGS)
@pytest.mark.parametrize("k", [1, 2, 3, 10])
def test_recall_and_mrr_at_k_match_jax(ranked, gold, k):
    """Rankings with the gold id at each place, past the cut-off, absent,
    and empty: the JAX values exactly."""
    assert tmetrics.recall_at_k(ranked, gold, k) == \
        jmetrics.recall_at_k(ranked, gold, k)
    assert tmetrics.mrr_at_k(ranked, gold, k) == \
        jmetrics.mrr_at_k(ranked, gold, k)
    assert tmetrics.mrr_at_k(ranked, gold) == jmetrics.mrr_at_k(ranked, gold)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A JAX checkpoint of the tiny model (rank-4, alpha-8 adapters,
    non-zero) with its options.json."""
    root = tmp_path_factory.mktemp("export")
    jopt = jconfig.Options(model_size="tiny", max_vocab=300, lora_rank=4,
                           lora_alpha=8.0, name="run",
                           checkpoint_dir=str(root))
    _, params, _ = jmodel_io.load_or_initialize_model(
        jopt, JStore.synthetic(4))
    rng = np.random.default_rng(0)
    params["lora"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), params["lora"])
    jsave_checkpoint(str(root), "run", 3, params, options=jopt)
    return str(root / "run" / "step-3")


def test_extract_towers_matches_the_jax_script(tiny_ckpt, tmp_path, capsys):
    """The port's ``extract_towers`` writes the files the JAX script
    writes: the towers equal, the merged generator (the run's rank 4 and
    alpha 8 read from options.json) within 1e-6; without CUDA the default
    device raises."""
    jextract.main(tiny_ckpt, str(tmp_path / "jax"))
    written = extract_towers.main([tiny_ckpt, str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.path.basename(p) for p in written)
    for name in os.listdir(tmp_path / "jax"):
        with open(tmp_path / "jax" / name, "rb") as f:
            want = _flat(pickle.load(f))
        with open(tmp_path / "port" / name, "rb") as f:
            got = _flat(pickle.load(f))
        assert set(got) == set(want), name
        for path, v in want.items():
            np.testing.assert_allclose(got[path], np.asarray(v), rtol=0,
                                       atol=1e-6, err_msg=f"{name} {path}")
    assert "step 3:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            extract_towers.main([tiny_ckpt, str(tmp_path / "no")])


def test_recall_mrr_prints_the_jax_scripts_json(tmp_path, capsys):
    """Predictions with the gold passage first, third, past 10 and
    missing, one question without gold: the same JSON line."""
    gold = [{"question": f"q{i}", "gold_doc": str(i)} for i in range(4)]
    preds = [{"query": "q0", "passages": [{"id": "0"}, {"id": "5"}]},
             {"question": "q1", "passages": [{"id": "9"}, {"id": "8"},
                                             {"id": "1"}]},
             {"query": "q2", "passages": [{"id": str(j)}
                                          for j in range(10, 30)]
              + [{"id": "2"}]},
             {"query": "q3", "passages": [{"id": "7"}]},
             {"query": "other", "passages": [{"id": "0"}]}]
    for name, rows in (("gold", gold), ("pred", preds)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    paths = [str(tmp_path / "gold.jsonl"), str(tmp_path / "pred.jsonl")]
    want = jrecall_mrr.main(*paths)
    jline = capsys.readouterr().out
    got = recall_mrr.main(paths)
    assert capsys.readouterr().out == jline
    assert got == want and want["n"] == 4
    assert want["MRR@10"] == pytest.approx((1 + 1 / 3) / 4)
