"""A tiny version of the DeepSeek-V2 training cell, for runs of the whole
harness on the CPU, as ``tiny.py`` gives the other cells': the flagship's
tiny towers, index and mix, a
generator of hidden 64, 4 heads, nope 16 / rope 8 / v 16, latent 32, 3
layers (the first dense), 8 experts of width 32, top 2, one shared expert,
DeepSeek-V2-Lite's YaRN, in float32.

Limits set at this size (CPU runs, seed 2**31 + 99): ``log_lm_gap`` as
``tiny.py`` sets it (0.01, float32 on both sides); ``route_faults``'s
margin 1e-5 (float32 on both sides: the router's inputs agree to ~1e-6);
``route_weight_gap`` 1e-4 (sound 4.5e-08; every router's choices moved
one expert on, 0.109)."""

from __future__ import annotations

from benchmark.tests.tiny import OVERRIDES as FLAGSHIP

GENERATOR = {"model_type": "deepseek_v2", "vocab_size": 600,
             "hidden_size": 64, "intermediate_size": 128,
             "moe_intermediate_size": 32, "num_hidden_layers": 3,
             "first_k_dense_replace": 1, "num_attention_heads": 4,
             "num_key_value_heads": 4, "kv_lora_rank": 32,
             "q_lora_rank": None, "qk_nope_head_dim": 16,
             "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
             "num_experts_per_tok": 2, "n_shared_experts": 1,
             "routed_scaling_factor": 1.0, "norm_topk_prob": False,
             "topk_method": "greedy", "scoring_func": "softmax",
             "moe_layer_freq": 1, "n_group": 1, "topk_group": 1,
             "rms_norm_eps": 1e-6, "rope_theta": 10000,
             "rope_scaling": {"type": "yarn", "factor": 40,
                              "original_max_position_embeddings": 4096,
                              "beta_fast": 32, "beta_slow": 1,
                              "mscale": 0.707, "mscale_all_dim": 0.707},
             "tie_word_embeddings": False, "torch_dtype": "float32",
             "initializer_range": 0.02}

_flag = FLAGSHIP["train-jsa-flagship"]
OVERRIDES = {
    "train-jsa-dsv2lite": {
        # the generator's config is the configuration's top level
        "config": {**{k: v for k, v in _flag["config"].items()
                      if k != "generator"}, **GENERATOR},
        "traffic": dict(_flag["traffic"]),
        "limits": {"log_lm_gap": {"op": "<=", "limit": 0.01},
                   "route_faults": {"op": "<=", "limit": 0,
                                    "margin": 1e-5},
                   "route_weight_gap": {"op": "<=", "limit": 1e-4}}},
}
