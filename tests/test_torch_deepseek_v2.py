"""The deepseek_v2 generator (``models/lm.py``: latent attention, YaRN,
routed and shared experts; ``models/lora.py``: unmerged expert adapters)
against the plain reference ``plain_deepseek_v2.py`` on seeded random
weights, at a small size on the CPU: hidden 64, 4 heads, nope 16 / rope 8
/ v 16, latent 32, 3 layers (the first dense), 8 experts of width 32, top 2,
one shared expert, vocabulary 512, DeepSeek-V2-Lite's YaRN.

Tolerances. Both sides compute in float32; the port sums in other orders
(the grouped products, the two-part attention logits, the f32 weighted sum
of the routed experts), so logits agree to 1e-5 absolute (they are ~1),
the loss to 1e-5 relative and each LoRA gradient to 1e-4 of its largest
entry. The routing matches exactly at these weights: every token's top-2
lies far from a tie at float32's rounding."""

import dataclasses
import filecmp
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import plain_deepseek_v2 as ref
from jsa_rag_tpu_torch import model_io
from jsa_rag_tpu_torch.config import Options
from jsa_rag_tpu_torch.data.passages import PassageStore
from jsa_rag_tpu_torch.index import build_index_for
from jsa_rag_tpu_torch.models import hf_write, lm, lora
from jsa_rag_tpu_torch.models.hf_import import deepseek_config_from_hf
from jsa_rag_tpu_torch.train.modes import StepRng
from jsa_rag_tpu_torch.train.optim import set_optim
from jsa_rag_tpu_torch.train.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707}
TINY = {"model_type": "deepseek_v2", "vocab_size": 512, "hidden_size": 64,
        "intermediate_size": 128, "moe_intermediate_size": 32,
        "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 1,
        "routed_scaling_factor": 1.0, "norm_topk_prob": False,
        "topk_method": "greedy", "scoring_func": "softmax",
        "moe_layer_freq": 1, "rms_norm_eps": 1e-6, "rope_theta": 10000,
        "rope_scaling": YARN, "tie_word_embeddings": False}
LORA = lora.LoRAConfig(rank=4, alpha=8.0)


def _model(seed=0, **over):
    c = {**TINY, **over}
    cfg = deepseek_config_from_hf(c, torch.float32)
    g = torch.Generator().manual_seed(seed)
    return c, cfg, lm.lm_init(cfg, device="cpu", generator=g)


def _adapters(params, seed=1):
    """LoRA over every target with B drawn non-zero (so A's gradient is
    not zero), every leaf requiring grad."""
    g = torch.Generator().manual_seed(seed)
    tree = lora.lora_init(params, LORA, generator=g, device="cpu")
    for layer in tree["layers"]:
        for ab in layer.values():
            ab["B"].normal_(0.0, 0.05, generator=g)
            ab["A"].requires_grad_()
            ab["B"].requires_grad_()
    return tree


def _batch(seed=2, b=3, s=20):
    """Right-padded rows (row 0 shorter), labels over the last real
    tokens."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(6, TINY["vocab_size"], (b, s), generator=g)
    mask = torch.ones_like(ids)
    mask[0, 15:] = 0
    labels = ids.clone()
    labels[:, :12] = -100
    labels[0, 15:] = -100
    return ids, mask, labels


def _leaves(tree):
    return [ab[k] for layer in tree["layers"] for ab in layer.values()
            for k in ("A", "B")]


def test_logits_match_the_plain_reference():
    c, cfg, p = _model()
    ids, mask, _ = _batch()
    got = lm.lm_logits(p, cfg, ids, mask)
    want = ref.logits(p, None, c, ids, mask)
    real = mask.bool()
    assert torch.allclose(got[real], want[real], atol=1e-5, rtol=0)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_lora_grads_match_the_plain_reference(remat):
    c, cfg, p = _model()
    cfg = dataclasses.replace(cfg, remat=remat)
    tree = _adapters(p)
    ids, mask, labels = _batch()
    per, _ = lm.lm_loss(lora.gen_params({"generator": p, "lora": tree},
                                        LORA), cfg, ids, mask, labels)
    got = torch.autograd.grad(per.mean(), _leaves(tree))
    ce, faults = ref.row_ce(p, tree, c, ids, mask, labels,
                            lora_scale=LORA.alpha / LORA.rank)
    want = torch.autograd.grad(ce.mean(), _leaves(tree))
    assert faults == 0
    assert torch.allclose(per, ce, rtol=1e-5, atol=0)
    for a, b in zip(got, want):
        assert b.abs().max() > 0
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_yarn_frequencies_and_scales_follow_the_formula():
    """DeepSeek-V2-Lite's rope (dim 64, theta 1e4, factor 40 over 4,096
    positions, beta 32 / 1, mscale 0.707 both): the correction range, the
    ramp between interpolated and extrapolated frequencies, and the
    softmax and cos/sin factors, worked out here from the formula."""
    _, cfg, _ = _model(qk_nope_head_dim=128, qk_rope_head_dim=64)
    d, base = 64, 10000.0

    def corr(rot):
        return d * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))
    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), d - 1)
    assert (low, high) == (10, 23)
    i = np.arange(d // 2)
    extra = base ** (-2.0 * i / d)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = lm.rope_inv_freq(cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.2608) < 1e-4
    assert lm.mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m,
                                                      rel=1e-12)
    assert lm.rope_mscale(cfg) == 1.0
    c64 = {**TINY, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64}
    np.testing.assert_allclose(ref.inv_freq(c64).numpy(), want, rtol=1e-6)
    assert ref.softmax_scale(c64) == pytest.approx(192 ** -0.5 * m * m)


def test_rotary_rotates_deepseeks_interleaved_pairs():
    """``_mla_rope`` equals HF's transpose-then-``rotate_half`` form."""
    _, cfg, _ = _model()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 4, 8, generator=g)
    pos = torch.arange(5)[None].expand(2, 5)
    got = lm._mla_rope(x, lm._mla_rotary(cfg, pos))
    cos, sin = ref.cos_sin(TINY, pos)
    want = ref.apply_rope(x.transpose(1, 2), cos, sin).transpose(1, 2)
    assert torch.allclose(got, want, atol=1e-6)


def test_unmerged_expert_adapters_equal_a_merged_copy():
    _, cfg, p = _model()
    tree = _adapters(p)
    ids, mask, _ = _batch()
    applied = lora.gen_params({"generator": p, "lora": tree}, LORA)
    assert set(applied["layers"][1]["adapters"]) == {
        "experts_gate_w", "experts_up_w", "experts_down_w"}
    assert "adapters" not in applied["layers"][0]
    merged = lora.lora_merge_export(p, tree, LORA)
    assert "adapters" not in merged["layers"][1]
    with torch.no_grad():
        a = lm.lm_logits(applied, cfg, ids, mask)
        b = lm.lm_logits(merged, cfg, ids, mask)
    assert torch.allclose(a, b, atol=1e-5, rtol=0)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("with_lora", [False, True])
def test_an_moe_layer_issues_the_same_ops_whatever_the_expert_count(
        with_lora):
    """No Python loop over the experts: one MoE layer's forward issues as
    many aten ops at 4 experts as at 16."""
    counts = []
    for e in (4, 16):
        _, cfg, p = _model(n_routed_experts=e)
        layer = p["layers"][1]
        if with_lora:
            layer = lora.gen_params({"generator": p, "lora": _adapters(p)},
                                    LORA)["layers"][1]
            layer = lm._cast_params({"embed": p["embed"], "lm_head":
                                     p["lm_head"], "layers": [layer]},
                                    cfg)["layers"][0]
        x = torch.randn(2, 9, TINY["hidden_size"])
        with torch.no_grad(), _Ops() as ops:
            lm._moe(layer, cfg, x)
        counts.append(ops.n)
    assert counts[0] == counts[1], counts


def test_a_jsa_step_trains_the_deepseek_generator():
    """One tiny jsa step through ``RAGModel.build_batch("jsa")`` and
    ``make_train_step``, the generator a ``deepseek`` preset: the loss is
    finite and the expert adapters' B take a gradient (AdamW's first
    moment; A's is zero while B starts at zero)."""
    opt = Options(model_size="tiny", generator_model_type="deepseek",
                  precision="fp32", use_lora=True, lora_rank=4,
                  gold_score_mode="jsa", n_context=3, mis_step=8,
                  text_maxlength=64, target_maxlength=12,
                  per_gpu_batch_size=2, index_dtype="float32", dropout=0.1,
                  use_gradient_checkpoint_generator=True, device="cpu",
                  max_vocab=600)
    store = PassageStore.synthetic(32, seed=0)
    model, params, _ = model_io.load_or_initialize_model(opt, store)
    assert model.gen_cfg.arch == "deepseek_v2"
    assert params["generator"]["layers"][1]["experts_gate_w"].shape == (
        8, 64, 32)
    index = build_index_for(opt, len(store), model.retriever.cfg.bert.hidden,
                            device="cpu")
    model.build_index(index, params)
    tx = set_optim(opt, params)
    names = ["/".join(p) for p in tx.paths]
    keys = [f"lora/layers/{i}/{n}/B" for i in (1, 2)
            for n in ("experts_gate_w", "experts_up_w", "experts_down_w")]
    assert set(keys) <= set(names)
    batch = model.build_batch("jsa", index, params,
                              ["what is w3 about", "what is w9 about"],
                              ["w4", "w10"])
    step = make_train_step(model, "jsa", tx)
    loss, _ = step(params, batch, StepRng.from_seed(0, torch.device("cpu")))
    assert math.isfinite(float(loss))
    for key in keys:
        assert tx.mu[names.index(key)].abs().max() > 0, key


def test_deepseek_presets_are_the_test_size_and_the_published_one():
    """``--model_size`` names a deepseek_v2 geometry as "tiny" (this file's
    size) or "large" (DeepSeek-V2-Lite's published widths and depth, as
    the benchmark's configuration states them); another is refused."""
    path = os.path.join(ROOT, "benchmark", "configs",
                        "nq-jsa-dsv2lite-bgelarge.json")
    with open(path) as f:
        g = json.load(f)  # the generator's config.json is its top level
    large = model_io.DEEPSEEK_PRESETS["large"]
    assert set(model_io.DEEPSEEK_PRESETS) == {"tiny", "large"}
    assert large == dict(
        hidden=g["hidden_size"], layers=g["num_hidden_layers"],
        heads=g["num_attention_heads"], intermediate=g["intermediate_size"],
        kv_lora_rank=g["kv_lora_rank"], qk_nope_dim=g["qk_nope_head_dim"],
        qk_rope_dim=g["qk_rope_head_dim"], v_head_dim=g["v_head_dim"],
        n_experts=g["n_routed_experts"],
        experts_per_token=g["num_experts_per_tok"],
        expert_intermediate=g["moe_intermediate_size"],
        n_shared_experts=g["n_shared_experts"])
    opt = Options(model_size="small", generator_model_type="deepseek",
                  precision="fp32", device="cpu", max_vocab=600)
    with pytest.raises(ValueError, match="names no deepseek_v2 geometry"):
        model_io.load_or_initialize_model(opt,
                                          PassageStore.synthetic(8, seed=0))


def test_hf_directory_round_trips_through_model_io(tmp_path):
    """A ``DeepseekV2ForCausalLM`` directory under HF's key names (every
    expert its own ``nn.Linear``) loads through ``model_io``'s HF path;
    the imported generator gives the plain reference's logits on HF's
    weights, the experts stacked in order."""
    path = str(tmp_path / "dsv2")
    g = torch.Generator().manual_seed(5)
    sd = hf_write.deepseek_v2_state_dict(TINY, hf_write.hf_init(g))
    hf_write.write_hf_dir(path, TINY)
    hf_write.write_safetensors(os.path.join(path, "model.safetensors"), sd)
    opt = Options(model_size="tiny", generator_model_path=path,
                  precision="fp32", use_lora=False, gold_score_mode="rag",
                  device="cpu", max_vocab=512)
    model, params, _ = model_io.load_or_initialize_model(
        opt, PassageStore.synthetic(8, seed=0))
    cfg = model.gen_cfg
    assert cfg.arch == "deepseek_v2" and cfg.n_experts == 8
    gen = params["generator"]
    e3 = sd["model.layers.2.mlp.experts.3.down_proj.weight"]
    assert torch.equal(gen["layers"][2]["experts_down_w"][3], e3.T)
    assert torch.equal(gen["layers"][1]["router_w"],
                       sd["model.layers.1.mlp.gate.weight"].T)
    ids, mask, _ = _batch()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        got = lm.lm_logits(gen, cfg32, ids, mask)
    want = ref.logits(gen, None, TINY, ids, mask)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_decoding_refuses_deepseek_v2(decode):
    _, cfg, p = _model()
    ids = torch.randint(6, 512, (2, 5))
    fn = lm.greedy_generate if decode == "greedy" else lm.beam_generate
    kw = {"num_beams": 2} if decode == "beam" else {}
    with pytest.raises(NotImplementedError, match="latent KV cache"):
        fn(p, cfg, ids, torch.ones_like(ids), max_new_tokens=3, eos_id=2,
           pad_id=0, **kw)


def test_the_benchmarks_reference_is_this_reference():
    here = os.path.join(ROOT, "tests", "plain_deepseek_v2.py")
    there = os.path.join(ROOT, "benchmark", "reference", "deepseek_v2.py")
    assert filecmp.cmp(here, there, shallow=False)
    assert "plain_deepseek_v2" in sys.modules
