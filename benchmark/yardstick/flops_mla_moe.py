"""Operations and bytes of a DeepSeek-V2 generator's training step
(multi-head latent attention, routed and shared experts), counted from the
real tokens of the rows a step ran, never from a kernel, as ``flops.py``
counts the llama family. A multiply-add is two operations. ``c`` is the
generator's HF-style config: the configuration file's top level. ``PERF.md`` writes each
formula out.

Per real token and layer, forward:

- MLA's projections: ``2 (H nh (dn + dr) + H (r + dr) + r nh (dn + dv) +
  nh dv H)``;
- causal attention over a sequence of T tokens: ``nh (dn + dr + dv) T (T
  + 1)`` (QK^T and PV over the causal triangle);
- a dense layer's SwiGLU: ``6 H F``; an MoE layer's router ``2 H E``, its
  routed experts ``k 6 H Fe`` (k of them a token), its shared experts
  ``6 H Fs``;
- the head ``2 H V`` at each scored position only.

LoRA (rank r): ``2 r (in + out)`` a target and token, the expert adapters
at the k experts each token is routed to. A step is the forward, the
backward to the activations (the frozen base takes no weight gradient; a
product's backward to its input costs its forward, attention's twice) and
the adapters' forward and backward (three times their forward); the remat
recompute is not counted.
"""

from __future__ import annotations


def _dims(c: dict):
    return (c["hidden_size"], c["num_attention_heads"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])


def mla_params(c: dict) -> int:
    """Weights of one layer's MLA projections (q, kv_a, kv_b, o)."""
    h, nh, dn, dr, dv, r = _dims(c)
    return h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv) + nh * dv * h


def attention_flops(c: dict, tokens: int) -> float:
    """One layer's causal QK^T and PV over a sequence of ``tokens``."""
    _, nh, dn, dr, dv, _ = _dims(c)
    return float(nh * (dn + dr + dv) * tokens * (tokens + 1))


def n_moe_layers(c: dict) -> int:
    return c["num_hidden_layers"] - c["first_k_dense_replace"]


def forward_flops(c: dict, tokens: int, labels: int) -> float:
    """The forward of one sequence of ``tokens`` real tokens whose
    ``labels`` positions are scored."""
    h, e, k = c["hidden_size"], c["n_routed_experts"], \
        c["num_experts_per_tok"]
    fe, fs = c["moe_intermediate_size"], \
        c["n_shared_experts"] * c["moe_intermediate_size"]
    n_dense, n_moe = c["first_k_dense_replace"], n_moe_layers(c)
    per_layer = 2 * mla_params(c) * tokens + attention_flops(c, tokens)
    dense = 6 * h * c["intermediate_size"] * tokens
    moe = (2 * h * e + k * 6 * h * fe + 6 * h * fs) * tokens
    head = 2 * h * c["vocab_size"] * labels
    return float(c["num_hidden_layers"] * per_layer + n_dense * dense
                 + n_moe * moe + head)


def lora_forward_flops(c: dict, rank: int, tokens: int) -> float:
    """The adapters' x A and (x A) B of every target, the routed experts'
    at the experts each token takes."""
    h, nh, dn, dr, dv, _ = _dims(c)
    fe, fs = c["moe_intermediate_size"], \
        c["n_shared_experts"] * c["moe_intermediate_size"]
    k = c["num_experts_per_tok"]
    attn = (h + nh * (dn + dr)) + (nh * dv + h)
    dense = 3 * (h + c["intermediate_size"])
    moe = 3 * (h + fs) + k * 3 * (h + fe)
    per = (c["num_hidden_layers"] * attn + c["first_k_dense_replace"] * dense
           + n_moe_layers(c) * moe)
    return float(2 * rank * per * tokens)


def train_flops(c: dict, rank: int, tokens: int, labels: int) -> float:
    """One sequence of a LoRA step: forward, backward to the activations,
    the adapters' forward and backward."""
    attn = c["num_hidden_layers"] * attention_flops(c, tokens)
    fwd = forward_flops(c, tokens, labels)
    bwd = (fwd - attn) + 2 * attn
    return float(fwd + bwd + 3 * lora_forward_flops(c, rank, tokens))


def expert_work(c: dict, rank: int, routed_tokens: int) -> tuple[float,
                                                                   float]:
    """The grouped expert products of one step -> (bf16 operations,
    bytes), over every MoE layer and the step's three passes over them
    (forward, remat recompute, backward). ``routed_tokens``: the real
    tokens of the step's rows, each routed to k experts (N = k x tokens
    rows in the groups).

    Operations: the gate, up and down products, ``6 N H Fe`` a pass (the
    backward's to the input; the frozen stacks take no weight gradient),
    and their adapters, ``6 N r (H + Fe)`` in the forward and the
    recompute and twice that in the backward (to the input and to A and
    B). Bytes: a pass reads each layer's three stacks once (``3 E H Fe``
    bf16) and its adapters' (``3 E r (H + Fe)``), and the rows in and out
    of each product (``N (in + out)`` bf16, the adapters' with their r-wide
    middle)."""
    h, e, k = c["hidden_size"], c["n_routed_experts"], \
        c["num_experts_per_tok"]
    fe = c["moe_intermediate_size"]
    n = k * routed_tokens
    base_ops = 6.0 * n * h * fe
    ad_ops = 6.0 * n * rank * (h + fe)
    ops = 3 * base_ops + 4 * ad_ops
    weights = 2.0 * 3 * e * h * fe + 2.0 * 3 * e * rank * (h + fe)
    rows = 2.0 * 3 * n * (h + fe) + 2.0 * 3 * n * (h + fe + 2 * rank)
    n_bytes = 3 * (weights + rows)
    layers = n_moe_layers(c)
    return layers * ops, layers * n_bytes
