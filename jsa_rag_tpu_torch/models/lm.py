"""Decoder-only LM (llama/mistral-family, gpt2 and deepseek_v2 geometry)
for generation.

Counterpart of ``jsa_rag_tpu/models/lm.py`` for the first two
architectures; the third has no counterpart there:

- llama/mistral: RMSNorm + rotary positions + grouped-query attention +
  SwiGLU; leaves ``embed``, ``final_norm``, ``lm_head`` (untied) and
  ``layers.<i>.{attn_norm, q_w, k_w, v_w, o_w, mlp_norm, gate_w, up_w,
  down_w}``;
- gpt2 (``lm.py:204-289``): learned positions (clipped into the table),
  pre-LayerNorm, a fused biased qkv projection over full multi-head
  attention, a tanh-gelu MLP and the head tied to the embedding; leaves
  ``embed``, ``pos_embed``, ``final_norm``, ``final_norm_b`` and
  ``layers.<i>.{ln1_s, ln1_b, qkv_w, qkv_b, o_w, o_b, ln2_s, ln2_b, fc_w,
  fc_b, proj_w, proj_b}``;
- deepseek_v2 (HF's ``modeling_deepseek.py``, DeepSeek-V2-Lite's shape;
  its widths in ``DeepseekV2Config``): RMSNorm blocks of multi-head latent attention (MLA) without a query
  latent, then a dense SwiGLU in the first ``first_dense_layers`` layers and
  a mixture of experts in the rest; YaRN rotary on the 64-wide rope parts.
  MLA: ``q = x q_w`` per head ``qk_nope_dim + qk_rope_dim`` wide; ``x
  kv_a_w`` gives the KV latent (RMS-normed by ``kv_norm``, then ``kv_b_w``
  to each head's ``qk_nope_dim`` key and ``v_head_dim`` value) and one rope
  key that every head shares; rotary rotates DeepSeek's interleaved pairs
  (HF views the rope part as (half, 2) and transposes before
  ``rotate_half``; ``_mla_rope`` computes the same, in that output order, so
  no weight column is permuted). The MoE layer routes every token in f32
  (softmax over ``router_w``, top ``experts_per_token``, their
  probabilities the weights), sorts the (token, slot) pairs by expert and runs each
  of the gate, up and down products as one grouped product
  (``torch._grouped_mm``) over the stacked experts ``experts_{gate, up,
  down}_w`` (E, in, out), then adds the shared experts' SwiGLU
  (``shared_{gate, up, down}_w``). Leaves ``embed``, ``final_norm``,
  ``lm_head`` and ``layers.<i>.{attn_norm, q_w, kv_a_w, kv_norm, kv_b_w,
  o_w, mlp_norm}`` with ``gate_w, up_w, down_w`` (dense) or ``router_w``
  and the expert stacks (MoE). Decoding through a cache (which needs a
  latent cache) is refused.

One ``lm_logits`` forward serves CE and scoring; greedy and beam decoding
run over preallocated KV caches (full MHA for gpt2). Plain functions on tensors
over a parameter dict with the JAX package's key names and (in, out) weight
layout (``x @ w``), so ``convert.py`` moves a numpy pytree into either
package.

Numerics follow the JAX package: RMSNorm and LayerNorm in f32 cast back to
the activation dtype, rotary angles and products in f32, attention logits
and the unembed accumulated in f32 (bf16 products are exact in f32; on the
card the f32 products run with TF32 off), a -1e9 additive mask, f32 softmax
cast to the activation dtype. The matmul weights and biases are cast to
``cfg.dtype`` once per call (the JAX package casts inside each matmul,
which gives the same numbers); norm scales stay as stored.

Training: the loss path is differentiable back to the stored leaves
through the casts. With ``cfg.dropout > 0`` and an ``rng`` (a CPU
generator), dropout runs where the JAX package places it (llama: the
attention probabilities, HF's ``attention_dropout``; gpt2: the embeddings,
the attention probabilities and both residual branches) from seeds drawn up
front; ``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``) with the same seeds.

Token ids must lie below ``cfg.vocab_size``: ``model_io`` refuses a
tokenizer with more ids than the embedding has rows (the JAX package's
``jnp.take`` reads NaN rows for them instead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from ..parallel.sharding import (copy_to_group, gather_last_dim,
                                 reduce_from_group)
from ..parallel import mesh
from ..utils import trace
from .bert import _layer_norm, dropout, split_seeds

IGNORE_INDEX = -100  # label mask value, same constant as the reference
MATMUL_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
# gpt2's projections and their biases, cast to the activation dtype
GPT2_WEIGHTS = ("qkv_w", "qkv_b", "o_w", "o_b", "fc_w", "fc_b", "proj_w",
                "proj_b")
# deepseek_v2's 2-D projections and expert stacks; its router stays as
# stored and is read in f32
DEEPSEEK_WEIGHTS = ("kv_a_w", "kv_b_w", "experts_gate_w", "experts_up_w",
                    "experts_down_w", "shared_gate_w", "shared_up_w",
                    "shared_down_w")
CAST_LEAVES = frozenset(MATMUL_WEIGHTS + GPT2_WEIGHTS + DEEPSEEK_WEIGHTS)
ARCHS = ("llama", "gpt2", "deepseek_v2")
GPT2_LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    intermediate: int = 14336
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    arch: str = "llama"
    remat: bool = False  # per-layer activation recomputation (training)
    max_positions: int = 1024  # gpt2's position table; unused by llama
    dropout: float = 0.0  # train-time attention dropout; needs an rng

    @property
    def head_dim(self) -> int:
        """One head's width where queries, keys and values share it
        (llama, gpt2); MLA's are ``qk_head_dim`` and ``v_head_dim``."""
        return self.hidden // self.heads

    @property
    def qk_head_dim(self) -> int:
        """A query or key head's width."""
        return self.head_dim

    @property
    def local_heads(self) -> tuple[int, int]:
        """(query heads, kv heads) of this rank's attention (gpt2: full
        MHA, its fused qkv never split; deepseek_v2: every head has its own
        key, ``qk_head_dim`` wide, and value, ``v_head_dim`` wide, made
        from the shared latent; never split)."""
        if self.arch in ("gpt2", "deepseek_v2"):
            return self.heads, self.heads
        tp = _tp(self, "attn")
        if tp is not None:
            return self.heads // tp.size, self.kv_heads // tp.size
        return self.heads, self.kv_heads


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config(LMConfig):
    """The deepseek_v2 generator: ``LMConfig``'s fields (``intermediate``
    is the dense layers' SwiGLU width, ``kv_heads`` equals ``heads``) and
    MLA's widths, the experts and YaRN."""

    arch: str = "deepseek_v2"
    kv_lora_rank: int = 512  # the KV latent's width
    qk_nope_dim: int = 128  # a query or key head's part without rotary
    qk_rope_dim: int = 64  # its rotary part (the key's shared by all heads)
    v_head_dim: int = 128
    n_experts: int = 64  # routed experts of an MoE layer
    experts_per_token: int = 6
    expert_intermediate: int = 1408  # each routed expert's SwiGLU width
    n_shared_experts: int = 2  # held as one SwiGLU, n x the expert width
    first_dense_layers: int = 1  # leading layers with the dense SwiGLU
    # YaRN: (factor, original max positions, beta_fast, beta_slow, mscale,
    # mscale_all_dim); DeepSeek-V2-Lite's
    yarn: tuple = (40.0, 4096, 32.0, 1.0, 0.707, 0.707)

    @property
    def qk_head_dim(self) -> int:
        """MLA's query and key heads: the nope and rope parts."""
        return self.qk_nope_dim + self.qk_rope_dim


@dataclasses.dataclass(frozen=True)
class TensorParallelLMConfig(LMConfig):
    """An ``LMConfig`` whose params are this rank's shards under tensor
    parallelism over a group; ``tp`` their layout
    (``parallel/sharding.TensorParallel``)."""

    tp: object = None


def with_tensor_parallel(cfg: LMConfig, tp) -> TensorParallelLMConfig:
    """``cfg`` for this rank's shards of the params, laid out as ``tp``."""
    if cfg.arch == "deepseek_v2":
        raise ValueError("tensor parallelism does not split the deepseek_v2 "
                         "generator (latent attention and its experts)")
    return TensorParallelLMConfig(
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(LMConfig)}, tp=tp)


def _tp(cfg: LMConfig, part: str):
    """The tensor-parallel layout when ``part`` ("attn", "mlp", "vocab") is
    split on this rank, else None."""
    tp = getattr(cfg, "tp", None)
    return tp if tp is not None and getattr(tp, part) else None


def _row_out(y, tp):
    """A row-split projection's output: the sum of the ranks' partial
    products, taken in f32 and cast once (Megatron's g)."""
    return y if tp is None else reduce_from_group(y, tp.group)


def _check_arch(cfg: LMConfig) -> None:
    if cfg.arch not in ARCHS:
        raise ValueError(f"generator arch {cfg.arch!r}: one of {ARCHS}")


def _check_decodes(cfg: LMConfig) -> None:
    """Decoding runs through a KV cache, which latent attention does not
    have yet."""
    _check_arch(cfg)
    if cfg.arch == "deepseek_v2":
        raise NotImplementedError(
            "greedy and beam decoding of the deepseek_v2 generator need a "
            "latent KV cache, which the port does not have yet; its "
            "training and scoring (lm_loss, lm_logits) run")


def lm_init(cfg: LMConfig, *, device, generator: torch.Generator) -> dict:
    """N(0, 0.02) f32 weights, unit norm scales, zero biases, the JAX
    tree's shapes."""
    _check_arch(cfg)

    def w(shape):
        return 0.02 * torch.randn(shape, generator=generator, device=device)

    def ones(n=cfg.hidden):
        return torch.ones((n,), device=device)

    def zeros(n=cfg.hidden):
        return torch.zeros((n,), device=device)

    hd = cfg.head_dim
    if cfg.arch == "gpt2":
        h, f = cfg.hidden, cfg.intermediate
        p = {"embed": w((cfg.vocab_size, h)),
             "pos_embed": w((cfg.max_positions, h)),
             "final_norm": ones(), "final_norm_b": zeros(), "layers": []}
        for _ in range(cfg.layers):
            p["layers"].append({
                "ln1_s": ones(), "ln1_b": zeros(),
                "qkv_w": w((h, 3 * h)), "qkv_b": zeros(3 * h),
                "o_w": w((h, h)), "o_b": zeros(),
                "ln2_s": ones(), "ln2_b": zeros(),
                "fc_w": w((h, f)), "fc_b": zeros(f),
                "proj_w": w((f, h)), "proj_b": zeros(),
            })
        return p  # the head is tied to the embedding
    p = {"embed": w((cfg.vocab_size, cfg.hidden)), "final_norm": ones(),
         "layers": []}
    if cfg.arch == "deepseek_v2":
        p["layers"] = [deepseek_layer_init(cfg, i, w, ones)
                       for i in range(cfg.layers)]
        p["lm_head"] = w((cfg.hidden, cfg.vocab_size))
        return p
    for _ in range(cfg.layers):
        p["layers"].append({
            "attn_norm": ones(),
            "q_w": w((cfg.hidden, cfg.heads * hd)),
            "k_w": w((cfg.hidden, cfg.kv_heads * hd)),
            "v_w": w((cfg.hidden, cfg.kv_heads * hd)),
            "o_w": w((cfg.heads * hd, cfg.hidden)),
            "mlp_norm": ones(),
            "gate_w": w((cfg.hidden, cfg.intermediate)),
            "up_w": w((cfg.hidden, cfg.intermediate)),
            "down_w": w((cfg.intermediate, cfg.hidden)),
        })
    if not cfg.tie_embeddings:
        p["lm_head"] = w((cfg.hidden, cfg.vocab_size))
    return p


def deepseek_shapes(cfg: LMConfig, i: int) -> list[tuple[str, tuple]]:
    """(leaf, shape) of layer ``i``'s matrices and expert stacks, in the
    order ``lm_init`` draws them."""
    h, nh = cfg.hidden, cfg.heads
    out = [("q_w", (h, nh * cfg.qk_head_dim)),
           ("kv_a_w", (h, cfg.kv_lora_rank + cfg.qk_rope_dim)),
           ("kv_b_w", (cfg.kv_lora_rank,
                       nh * (cfg.qk_nope_dim + cfg.v_head_dim))),
           ("o_w", (nh * cfg.v_head_dim, h))]
    if i < cfg.first_dense_layers:
        f = cfg.intermediate
        return out + [("gate_w", (h, f)), ("up_w", (h, f)),
                      ("down_w", (f, h))]
    e, f = cfg.n_experts, cfg.expert_intermediate
    fs = cfg.n_shared_experts * f
    return out + [("router_w", (h, e)),
                  ("experts_gate_w", (e, h, f)), ("experts_up_w", (e, h, f)),
                  ("experts_down_w", (e, f, h)),
                  ("shared_gate_w", (h, fs)), ("shared_up_w", (h, fs)),
                  ("shared_down_w", (fs, h))]


def deepseek_layer_init(cfg: LMConfig, i: int, w, ones) -> dict:
    """Layer ``i`` of a deepseek_v2 tree: ``w(shape)`` for every matrix
    and stack, ``ones(n)`` for the three norm scales."""
    layer = {name: w(shape) for name, shape in deepseek_shapes(cfg, i)}
    layer.update(attn_norm=ones(cfg.hidden), kv_norm=ones(cfg.kv_lora_rank),
                 mlp_norm=ones(cfg.hidden))
    return layer


def _tied(cfg: LMConfig) -> bool:
    return cfg.tie_embeddings or cfg.arch == "gpt2"


def _cast_params(params: dict, cfg: LMConfig) -> dict:
    """The matmul weights (and gpt2's biases) and the embedding tables in
    ``cfg.dtype``; the head rounded to ``cfg.dtype`` and held in f32 for
    the f32-accumulated unembed; the norm scales as stored, as in the JAX
    package, where ``y * scale`` runs in f32."""
    dt = cfg.dtype
    out = {k: v for k, v in params.items() if k != "layers"}
    out["embed"] = params["embed"].to(dt)
    if "pos_embed" in params:
        out["pos_embed"] = params["pos_embed"].to(dt)
    head = params["embed"].T if _tied(cfg) else params["lm_head"]
    out["head"] = head.to(dt).to(torch.float32)
    out["layers"] = [{k: (v.to(dt) if k in CAST_LEAVES else v)
                      for k, v in layer.items()}
                     for layer in params["layers"]]
    for layer in out["layers"]:
        if "adapters" in layer:  # unmerged expert adapters (models/lora.py)
            layer["adapters"] = {n: (a.to(dt), b.to(dt), s)
                                 for n, (a, b, s) in layer["adapters"].items()}
    return out


def _rms_norm(x, scale, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rope_angles(positions, half: int, theta):
    """(cos, sin) of the rotary angles, each (B, S, 1, half) f32."""
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x, positions, theta, angles=None):
    """x: (B, S, N, D); positions: (B, S); ``angles``: their
    ``_rope_angles``, when the caller shares them across layers."""
    half = x.shape[-1] // 2
    cos, sin = angles or _rope_angles(positions, half, theta)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def positions_from_mask(attention_mask) -> torch.Tensor:
    """Left- or right-padding agnostic positions: cumsum(mask)-1, clamped."""
    return (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp_min(0)


def _attention(layer, cfg: LMConfig, x, positions, bias, cache=None,
               cache_len: int = 0, seed=None):
    """GQA attention. With ``cache`` = (k, v) of (B, T, kv_heads, hd), this
    call's k/v are written into it in place at ``cache_len`` (JAX returns an
    updated copy; in place saves a cache's worth of memory per step) and the
    queries attend over the whole window, ``bias`` masking the rest."""
    b, s, _ = x.shape
    (nh, nkv), hd = cfg.local_heads, cfg.head_dim
    tp = _tp(cfg, "attn")
    if tp is not None:
        x = copy_to_group(x, tp.group)
    q = (x @ layer["q_w"]).reshape(b, s, nh, hd)
    k = (x @ layer["k_w"]).reshape(b, s, nkv, hd)
    v = (x @ layer["v_w"]).reshape(b, s, nkv, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv = cache
        ck[:, cache_len:cache_len + s] = k
        cv[:, cache_len:cache_len + s] = v
        k, v = ck, cv
    # grouped-query attention without repeating k/v: the grouped queries
    # contract directly against the shared kv heads
    rep = nh // nkv
    qg = q.reshape(b, s, nkv, rep, hd).to(torch.float32)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg,
                          k.to(torch.float32)) / math.sqrt(hd)
    logits = logits + bias[:, None]  # (b, 1, q, k) -> (b, 1, 1, q, k)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    probs = dropout(probs, cfg.dropout, seed)
    ctx = torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(b, s, nh * hd)
    return _row_out(ctx @ layer["o_w"], tp)


def _mlp(layer, x, tp=None):
    if tp is not None:
        x = copy_to_group(x, tp.group)
    g = x @ layer["gate_w"]
    u = x @ layer["up_w"]
    return _row_out((torch.nn.functional.silu(g) * u) @ layer["down_w"], tp)


def _block(layer, cfg: LMConfig, x, positions, bias, cache=None,
           cache_len: int = 0, seed=None):
    x = x + _attention(layer, cfg, _rms_norm(x, layer["attn_norm"],
                                             cfg.rms_eps),
                       positions, bias, cache, cache_len, seed)
    return x + _mlp(layer, _rms_norm(x, layer["mlp_norm"], cfg.rms_eps),
                    _tp(cfg, "mlp"))


# ------------------------------------------------------------- deepseek_v2
def yarn_get_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(scale) + 1`` (1 at no
    scaling)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, base: float,
                         max_positions: int) -> float:
    return (dim * math.log(max_positions / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def rope_inv_freq(cfg: LMConfig, device=None) -> torch.Tensor:
    """The (qk_rope_dim / 2,) f32 inverse frequencies of MLA's rotary:
    YaRN's (``DeepseekV2YarnRotaryEmbedding``) blend of the extrapolated
    ``theta^(-2i/d)`` and the interpolated ``/ factor`` ones, by a linear
    ramp over the correction range that ``beta_fast`` and ``beta_slow``
    give."""
    d = cfg.qk_rope_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    extra = 1.0 / (cfg.rope_theta ** exps)
    factor, orig, beta_fast, beta_slow, _, _ = cfg.yarn
    low = max(math.floor(_yarn_correction_dim(beta_fast, d, cfg.rope_theta,
                                              orig)), 0)
    high = min(math.ceil(_yarn_correction_dim(beta_slow, d, cfg.rope_theta,
                                              orig)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1: the extrapolated frequency, 0: the interpolated
    return extra / factor * (1 - keep) + extra * keep


def rope_mscale(cfg: LMConfig) -> float:
    """YaRN's factor on cos and sin: m(mscale) / m(mscale_all_dim)."""
    factor, _, _, _, mscale, mscale_all = cfg.yarn
    return yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor,
                                                             mscale_all)


def mla_softmax_scale(cfg: LMConfig) -> float:
    """``qk_head_dim^-0.5 m(mscale_all_dim)^2``."""
    m = yarn_get_mscale(cfg.yarn[0], cfg.yarn[5])
    return cfg.qk_head_dim ** -0.5 * m * m


def _mla_rotary(cfg: LMConfig, positions):
    """(cos, sin), each (B, S, 1, qk_rope_dim / 2) f32, of the rotary
    angles at ``positions``; once a forward, for every layer."""
    ang = positions[..., None].to(torch.float32) * rope_inv_freq(
        cfg, positions.device)
    m = rope_mscale(cfg)
    return (torch.cos(ang)[:, :, None] * m, torch.sin(ang)[:, :, None] * m)


def _mla_rope(x, rot):
    """DeepSeek's rotary of ``x`` (B, S, N, D): the pairs (x[2i], x[2i+1])
    rotate by angle i; the output holds the evens' results, then the
    odds' (HF's order after its transpose and ``rotate_half``)."""
    cos, sin = rot
    xf = x.to(torch.float32)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mla_attention(layer, cfg: LMConfig, x, rot, bias, seed=None):
    """Multi-head latent attention (``DeepseekV2Attention``, no query
    latent): the keys' nope parts and the values from the normed latent,
    one rope key for every head; logits summed in f32 from the nope and
    rope products (the concatenated heads' dot product), scaled by
    ``mla_softmax_scale``; f32 softmax cast to the activation dtype,
    dropout on it as in llama's."""
    with trace.span("mla.attention"):
        b, s, _ = x.shape
        nh, dn, dv = cfg.heads, cfg.qk_nope_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        q = (x @ layer["q_w"]).reshape(b, s, nh, dn + cfg.qk_rope_dim)
        ckv = x @ layer["kv_a_w"]
        kv = (_rms_norm(ckv[..., :r], layer["kv_norm"], cfg.rms_eps)
              @ layer["kv_b_w"]).reshape(b, s, nh, dn + dv)
        q_pe = _mla_rope(q[..., dn:], rot)
        k_pe = _mla_rope(ckv[..., None, r:], rot)[:, :, 0]
        f32 = torch.float32
        logits = (torch.einsum("bqnd,bknd->bnqk", q[..., :dn].to(f32),
                               kv[..., :dn].to(f32))
                  + torch.einsum("bqnd,bkd->bnqk", q_pe.to(f32),
                                 k_pe.to(f32))) * mla_softmax_scale(cfg)
        probs = torch.softmax(logits + bias, dim=-1).to(x.dtype)
        probs = dropout(probs, cfg.dropout, seed)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs,
                           kv[..., dn:]).reshape(b, s, nh * dv)
        return ctx @ layer["o_w"]


def route(h, router_w, k: int):
    """The router (``MoEGate``, greedy, its probabilities not renormalised,
    scaled by 1): softmax over ``h @ router_w`` in f32, the top ``k``
    experts of each row -> (weights (T, k) f32, expert ids (T, k)
    int64)."""
    scores = torch.softmax(h.to(torch.float32) @ router_w.to(torch.float32),
                           dim=-1)
    return torch.topk(scores, k, dim=-1)


def _grouped(x, layer, name: str, offs):
    """Rows ``x`` sorted by expert through the stack ``layer[name]`` (E,
    in, out) as one grouped product (expert e takes rows [offs[e-1],
    offs[e])), plus its unmerged LoRA adapter, ``scale (x A_e) B_e``,
    grouped alike, where ``models/lora.py`` left one."""
    y = torch._grouped_mm(x, layer[name], offs=offs)
    ad = layer.get("adapters", {}).get(name)
    if ad is not None:
        a, b, scale = ad
        y = y + torch._grouped_mm(torch._grouped_mm(x, a, offs=offs), b,
                                  offs=offs) * scale
    return y


def _swiglu(layer, x, prefix: str = ""):
    g = x @ layer[prefix + "gate_w"]
    return (torch.nn.functional.silu(g) * (x @ layer[prefix + "up_w"])) \
        @ layer[prefix + "down_w"]


def _moe(layer, cfg: LMConfig, x):
    """An MoE layer (``DeepseekV2MoE``) over every position of ``x`` (B,
    S, H): route, sort the (token, slot) pairs by expert (no host
    synchronisation: the group offsets stay on the device), gather, the
    grouped SwiGLU, back to (token, slot) order, the f32 sum weighted by
    the router cast to ``x``'s dtype, plus the shared experts."""
    b, s, hid = x.shape
    h = x.reshape(b * s, hid)
    k, e = cfg.experts_per_token, cfg.n_experts
    with trace.span("moe.route"):
        weights, ids = route(h, layer["router_w"], k)
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(e, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        offs = torch.cumsum(counts, 0).to(torch.int32)
    with trace.span("moe.experts"):
        xs = h[order // k]
        g = _grouped(xs, layer, "experts_gate_w", offs)
        u = _grouped(xs, layer, "experts_up_w", offs)
        y = _grouped(torch.nn.functional.silu(g) * u, layer,
                     "experts_down_w", offs)
        y = y.new_empty(y.shape).index_copy(0, order, y)
        routed = (y.view(b * s, k, hid).to(torch.float32)
                  * weights[..., None]).sum(dim=1).to(x.dtype)
    with trace.span("moe.shared"):
        shared = _swiglu(layer, h, "shared_")
    return (routed + shared).reshape(b, s, hid)


def _deepseek_block(layer, cfg: LMConfig, x, rot, bias, seed=None):
    x = x + _mla_attention(layer, cfg, _rms_norm(x, layer["attn_norm"],
                                                 cfg.rms_eps),
                           rot, bias, seed)
    h = _rms_norm(x, layer["mlp_norm"], cfg.rms_eps)
    return x + (_moe(layer, cfg, h) if "router_w" in layer
                else _swiglu(layer, h))


def _gpt2_out(layer, cfg: LMConfig, ctx):
    """gpt2's output projection; under tensor parallelism its rows are
    split (its qkv is not), so each rank multiplies its columns of the
    full context."""
    tp = _tp(cfg, "attn")
    if tp is not None:
        n = layer["o_w"].shape[0]
        ctx = copy_to_group(ctx, tp.group)[..., tp.rank * n:(tp.rank + 1) * n]
    return _row_out(ctx @ layer["o_w"], tp) + layer["o_b"]


def _gpt2_attention(layer, cfg: LMConfig, x, bias, cache=None,
                    cache_len: int = 0, seed=None):
    """gpt2 attention (``lm.py:204-229``): fused biased qkv, no rotary,
    full MHA; the cache as in ``_attention``."""
    b, s, h = x.shape
    nh, hd = cfg.heads, cfg.head_dim
    qkv = x @ layer["qkv_w"] + layer["qkv_b"]
    q, k, v = (t.reshape(b, s, nh, hd) for t in qkv.split(h, dim=-1))
    if cache is not None:
        ck, cv = cache
        ck[:, cache_len:cache_len + s] = k
        cv[:, cache_len:cache_len + s] = v
        k, v = ck, cv
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    probs = torch.softmax(logits + bias, dim=-1).to(x.dtype)
    probs = dropout(probs, cfg.dropout, seed)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, h)
    return _gpt2_out(layer, cfg, ctx)


def _gpt2_block(layer, cfg: LMConfig, x, bias, cache=None,
                cache_len: int = 0, seeds=(None, None, None)):
    """``seeds``: the (attention probs, attention residual, MLP residual)
    dropout seeds (``lm.py:232-243``)."""
    a = _gpt2_attention(layer, cfg, _layer_norm(x, layer["ln1_s"],
                                                layer["ln1_b"], GPT2_LN_EPS),
                        bias, cache, cache_len, seeds[0])
    x = x + dropout(a, cfg.dropout, seeds[1])
    return x + dropout(_gpt2_mlp(layer, x), cfg.dropout, seeds[2])


def _gpt2_mlp(layer, x):
    h = _layer_norm(x, layer["ln2_s"], layer["ln2_b"], GPT2_LN_EPS)
    h = torch.nn.functional.gelu(h @ layer["fc_w"] + layer["fc_b"],
                                 approximate="tanh")
    return h @ layer["proj_w"] + layer["proj_b"]


def _embed_in(p: dict, cfg: LMConfig, input_ids, positions):
    """Token embeddings in ``cfg.dtype``; gpt2 adds its learned position
    rows, the positions clipped into the table (``lm.py:246-251``)."""
    tp = _tp(cfg, "vocab")
    if tp is None:
        x = p["embed"][input_ids.long()]
    else:  # this rank's vocab rows, the others' zero, summed over ranks
        n = p["embed"].shape[0]
        local = input_ids.long() - tp.rank * n
        own = (local >= 0) & (local < n)
        x = p["embed"][torch.where(own, local, 0)]
        x = reduce_from_group(torch.where(own[..., None], x, 0), tp.group)
    if cfg.arch == "gpt2":
        pos = positions.long().clamp(0, cfg.max_positions - 1)
        x = x + p["pos_embed"][pos]
    return x


def _final_norm(p: dict, cfg: LMConfig, x):
    if cfg.arch == "gpt2":
        return _layer_norm(x, p["final_norm"], p["final_norm_b"],
                           GPT2_LN_EPS)
    return _rms_norm(x, p["final_norm"], cfg.rms_eps)


def _unembed(p: dict, cfg: LMConfig, x):
    """f32 logits of the final-normed hidden states: the activation-dtype
    products are exact in f32 and summed there (the JAX package's
    ``preferred_element_type=f32``). Under a split vocab: this rank's
    columns of them."""
    x = _final_norm(p, cfg, x).to(torch.float32)
    tp = _tp(cfg, "vocab")
    if tp is not None:
        x = copy_to_group(x, tp.group)
    return x @ p["head"]


def _full_vocab(cfg: LMConfig, logits):
    """Logits over the whole vocabulary: a split vocab's columns gathered
    over the group."""
    tp = _tp(cfg, "vocab")
    return logits if tp is None else gather_last_dim(logits, tp.group,
                                                     tp.rank)


def token_logprobs(cfg: LMConfig, logits, targets):
    """log softmax(logits)[target] over the vocabulary, (..., V) ->
    (...). Under a split vocab it is computed without gathering the
    logits: the max and the sum of exps are all-reduced over the group,
    and the target's logit comes from the rank that owns it."""
    tp = _tp(cfg, "vocab")
    if tp is None:
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, targets[..., None])[..., 0]
    n = logits.shape[-1]
    top = logits.detach().amax(dim=-1)
    mesh.all_reduce_(top, torch.distributed.ReduceOp.MAX, group=tp.group)
    z = logits - top[..., None]
    sumexp = reduce_from_group(torch.exp(z).sum(dim=-1), tp.group)
    local = targets - tp.rank * n
    own = (local >= 0) & (local < n)
    zt = torch.gather(z, -1, torch.where(own, local, 0)[..., None])[..., 0]
    zt = reduce_from_group(torch.where(own, zt, 0.0), tp.group)
    return zt - torch.log(sumexp)


def _layer_fn(cfg: LMConfig):
    """-> (block(layer, x, positions, bias, cache, cache_len, seeds), the
    number of dropout seeds a layer takes)."""
    if cfg.arch == "gpt2":
        def block(layer, x, positions, bias, cache, cache_len, seeds):
            return _gpt2_block(layer, cfg, x, bias, cache, cache_len, seeds)
        return block, 3
    if cfg.arch == "deepseek_v2":  # ``positions``: ``_mla_rotary``'s
        def block(layer, x, positions, bias, cache, cache_len, seeds):
            return _deepseek_block(layer, cfg, x, positions, bias, seeds[0])
        return block, 1

    def block(layer, x, positions, bias, cache, cache_len, seeds):
        return _block(layer, cfg, x, positions, bias, cache, cache_len,
                      seeds[0])
    return block, 1


def _local_logits(params: dict, cfg: LMConfig, input_ids, attention_mask,
                  positions=None, rng=None) -> torch.Tensor:
    """``lm_logits`` before the vocab gather."""
    _check_arch(cfg)
    p = _cast_params(params, cfg)
    s = input_ids.shape[1]
    if positions is None:
        positions = positions_from_mask(attention_mask)
    x = _embed_in(p, cfg, input_ids, positions)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=x.device))[None, None]
    keymask = attention_mask[:, None, None, :].bool()
    bias = torch.where(causal & keymask, 0.0, -1e9).to(torch.float32)
    block, per = _layer_fn(cfg)
    if cfg.arch == "deepseek_v2":  # the rotary's angles, once a forward
        positions = _mla_rotary(cfg, positions)
    # gpt2 drops out its embeddings first (embd_pdrop), then 3 per layer
    first = 1 if cfg.arch == "gpt2" else 0
    seeds = split_seeds(rng if cfg.dropout > 0.0 else None,
                        first + per * cfg.layers)
    if first:
        x = dropout(x, cfg.dropout, seeds[0])
    for i, layer in enumerate(p["layers"]):
        lseeds = tuple(seeds[first + per * i:first + per * (i + 1)])
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                block, layer, x, positions, bias, None, 0, lseeds,
                use_reentrant=False)
        else:
            x = block(layer, x, positions, bias, None, 0, lseeds)
    return _unembed(p, cfg, x)


def lm_logits(params: dict, cfg: LMConfig, input_ids, attention_mask,
              positions=None, rng=None) -> torch.Tensor:
    """(B, S) -> (B, S, V) f32 logits. Causal + padding mask; ``rng`` (a
    CPU generator) turns on train-time dropout. Under a split vocab the
    ranks' columns are gathered (for decoding and choice scoring; the
    losses never gather them)."""
    return _full_vocab(cfg, _local_logits(params, cfg, input_ids,
                                          attention_mask, positions, rng))


def lm_loss(params: dict, cfg: LMConfig, input_ids, attention_mask, labels,
            *, length_normalized: bool = True, logit_temp: float = 1.0,
            rng=None):
    """Causal-LM cross entropy with IGNORE_INDEX masking -> (per-sequence
    loss (B,), summed NLL (B,)); length-normalised like the reference's
    per-sequence CE (src/rag.py:1338-1366). ``logit_temp`` divides the
    logits before CE (``temperature_gold``, src/rag.py:1349)."""
    logits = _local_logits(params, cfg, input_ids, attention_mask, rng=rng)
    if logit_temp != 1.0:
        logits = logits / logit_temp
    # next-token prediction: logits[t] predicts token t+1
    logits = logits[:, :-1]
    targets = labels[:, 1:].long()
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0)
    tok_logp = torch.where(valid, token_logprobs(cfg, logits, safe), 0.0)
    n_tok = valid.sum(dim=1).clamp_min(1)
    sum_nll = -tok_logp.sum(dim=1)
    if length_normalized:
        return sum_nll / n_tok, sum_nll
    return sum_nll, sum_nll


def lm_sequence_logprob(params, cfg, input_ids, attention_mask, labels,
                        *, length_normalized: bool = True):
    """log p(target | prompt) per sequence (the reference's
    ``get_llm_score``, src/rag.py:2328-2345)."""
    per_seq, _ = lm_loss(params, cfg, input_ids, attention_mask, labels,
                         length_normalized=length_normalized)
    return -per_seq


# ------------------------------------------------------------------ decoding
def init_cache(cfg: LMConfig, batch: int, max_len: int, device):
    hd = cfg.head_dim
    # gpt2 attention is full MHA: its cache holds cfg.heads kv heads
    nkv = cfg.local_heads[1]
    return [(torch.zeros((batch, max_len, nkv, hd), dtype=cfg.dtype,
                         device=device),
             torch.zeros((batch, max_len, nkv, hd), dtype=cfg.dtype,
                         device=device))
            for _ in range(cfg.layers)]


def _forward_with_cache(p, cfg, input_ids, attention_mask, positions,
                        cache, cache_len: int, total_len: int):
    """Shared by prefill (S = prompt length) and decode (S = 1) over the
    cast params ``p``; ``attention_mask`` is the mask over the FULL cache
    window (B, total_len). Returns the LAST position's (B, V) f32 logits
    (all that decoding reads; the JAX package unembeds every position and
    takes the last, the same numbers)."""
    s = input_ids.shape[1]
    dev = input_ids.device
    x = _embed_in(p, cfg, input_ids, positions)
    k_pos = torch.arange(total_len, device=dev)[None, :]
    causal = (k_pos[:, None, :]
              <= (cache_len + torch.arange(s, device=dev))[None, :, None])
    keymask = attention_mask[:, None, :].bool()
    bias = torch.where((causal & keymask)[:, None], 0.0,
                       -1e9).to(torch.float32)
    block, per = _layer_fn(cfg)
    for layer, lc in zip(p["layers"], cache):
        x = block(layer, x, positions, bias, lc, cache_len, (None,) * per)
    return _full_vocab(cfg, _unembed(p, cfg, x[:, -1]))


def _apply_forced_prefix(choice, t: int, forced_prefix, forced_len):
    """Force ``choice[b] = forced_prefix[b, t]`` while ``t < forced_len[b]``
    (the reference's ``prefix_allowed_tokens_fn``, src/rag.py:2244-2274)."""
    forced_t = forced_prefix[:, min(t, forced_prefix.shape[1] - 1)]
    return torch.where(t < forced_len, forced_t.long(), choice)


def greedy_generate(params: dict, cfg: LMConfig, input_ids, attention_mask,
                    *, max_new_tokens: int, eos_id: int, pad_id: int,
                    min_new_tokens: int = 0, forced_prefix=None,
                    forced_len=None, return_logprobs: bool = False):
    """Greedy decode with a preallocated KV cache (``lm.py:538-642``).

    ``input_ids`` must be LEFT-padded. Returns (B, max_new_tokens) int64
    ids, ``pad_id`` after EOS; with ``return_logprobs`` also the (B,
    max_new_tokens) f32 log-prob of each emitted token (0 after EOS).
    ``min_new_tokens`` bans EOS (``eos_id`` >= 0) until that many tokens
    are out; ``forced_prefix``/``forced_len`` ((B, P), (B,)) force each
    row's first tokens. The loop stops once every row has emitted EOS; the
    pad-initialised buffers make the outputs equal those of a full-length
    loop."""
    _check_decodes(cfg)
    p = _cast_params(params, cfg)  # once per call, not once per step
    b, prompt_len = input_ids.shape
    dev = input_ids.device
    total = prompt_len + max_new_tokens
    cache = init_cache(cfg, b, total, dev)
    positions = positions_from_mask(attention_mask)
    mask = torch.cat([attention_mask.long(),
                      torch.zeros((b, max_new_tokens), dtype=torch.long,
                                  device=dev)], dim=1)

    def pick(logits, t):
        """(token, its log-prob) from step-t logits (t counts emitted
        tokens), with the EOS ban and the forced prefix."""
        if t < min_new_tokens and eos_id >= 0:
            logits = logits.clone()
            logits[:, eos_id] = -torch.inf
        tok = torch.argmax(logits, dim=-1)
        if forced_prefix is not None:
            tok = _apply_forced_prefix(tok, t, forced_prefix, forced_len)
        lp = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                          tok[:, None])[:, 0]
        return tok, lp

    with torch.no_grad():
        logits = _forward_with_cache(p, cfg, input_ids, mask, positions,
                                     cache, 0, total)
        tok, lp = pick(logits, 0)
        pos = positions[:, -1] + 1
        done = tok == eos_id
        toks = torch.full((b, max_new_tokens), pad_id, dtype=torch.long,
                          device=dev)
        lps = torch.zeros((b, max_new_tokens), dtype=torch.float32,
                          device=dev)
        for t in range(max_new_tokens):
            toks[:, t] = tok
            lps[:, t] = lp
            # every row done: all later tokens are pad; the last step's
            # forward would feed nothing
            if t + 1 == max_new_tokens or bool(done.all()):
                break
            mask[:, prompt_len + t] = 1
            logits = _forward_with_cache(p, cfg, tok[:, None], mask,
                                         pos[:, None], cache,
                                         prompt_len + t, total)
            new_tok, new_lp = pick(logits, t + 1)
            tok = torch.where(done, pad_id, new_tok)
            lp = torch.where(done, 0.0, new_lp)  # post-EOS pads score 0
            done = done | (tok == eos_id)
            pos = pos + 1
    if return_logprobs:
        return toks, lps
    return toks




# --------------------------------------------------------------- beam search
BEAM_NEG = -1.0e9  # the running and finished sets' mask score, as in HF
# the early exit reads the device's "some row unsatisfied" flag on the host
# once every this many steps; the steps in between are frozen no-ops on the
# device, so the result does not depend on it
EXIT_CHECK_EVERY = 8


class BeamResult(NamedTuple):
    """Each batch row's best finished hypothesis: its (B, T) ids (pad after
    EOS), their (B, T) f32 log-probs (0 in the pad tail) and its (B,)
    length-normalised score; ``steps`` is the number of decode steps the
    search ran before its early exit (a 0-dim tensor)."""
    ids: torch.Tensor
    logprobs: torch.Tensor
    scores: torch.Tensor
    steps: torch.Tensor


def top_k_lax(x, k: int):
    """The ``k`` largest entries of ``x``'s last dimension in
    ``jax.lax.top_k``'s order: descending, equal values lowest index first
    (``torch.topk`` leaves the order of ties open, at the k-th place too).
    Each f32 value and its index pack into one int64 key that orders as
    the IEEE total order of the values (-0.0 below +0.0) and then by
    ascending index, so one ``torch.topk`` over distinct keys returns that
    order exactly. -> (values, int64 indices)."""
    n = x.shape[-1]
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    # a non-negative float's bits order as the float; a negative one's
    # (sign bit set) run backwards: map them below every non-negative key
    key = torch.where(bits >= 0, bits, -(2 ** 31) - 1 - bits)
    low = (1 << 32) - 1
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    packed = key * (1 << 32) + (low - idx)
    top = torch.topk(packed, k, dim=-1).values
    idx = low - (top & low)
    return torch.gather(x, -1, idx), idx


def _length_norm(n: int, length_penalty: float) -> float:
    """``n ** length_penalty`` rounded to f32 (the JAX package computes it
    in f32)."""
    return float(torch.tensor(float(n) ** length_penalty,
                              dtype=torch.float32))


def _beam_attend(qg, prompt_kv, gen_k, gen_v, prompt_bias, t: int, dtype):
    """One decode step's attention of every beam over the prompt cache its
    batch row shares and its own generation-cache slots [0, t].

    qg: (B, K, G, R, D) grouped queries (G kv heads, R query heads each;
    gpt2's full MHA passes R = 1); prompt k/v (B, P, G, D), held in f32
    (the cache's values, upcast once a search); generation k/v time-major
    (T, B*K, G, D). Logits and the value sums in f32, the softmax cast to
    ``dtype`` (the greedy path's numerics: its one contraction over the
    window is these two summed in f32). -> (B*K, 1, G*R*D) in
    ``dtype``."""
    b, kb, g, r, d = qg.shape
    pk, pv = prompt_kv
    gk = gen_k[:t + 1].reshape(t + 1, b, kb, g, d).to(torch.float32)
    gv = gen_v[:t + 1].reshape(t + 1, b, kb, g, d).to(torch.float32)
    q = qg.to(torch.float32)
    scale = math.sqrt(d)
    sp = torch.einsum("bkgrd,bpgd->bkgrp", q, pk) / scale
    sg = torch.einsum("bkgrd,tbkgd->bkgrt", q, gk) / scale
    logits = torch.cat([sp + prompt_bias[:, None, None, None, :], sg], -1)
    probs = torch.softmax(logits, dim=-1).to(dtype).to(torch.float32)
    p_len = pk.shape[1]
    ctx = (torch.einsum("bkgrp,bpgd->bkgrd", probs[..., :p_len], pv)
           + torch.einsum("bkgrt,tbkgd->bkgrd", probs[..., p_len:], gv))
    return ctx.to(dtype).reshape(b * kb, 1, g * r * d)


def _beam_decode_forward(p, cfg: LMConfig, tok, positions, prompt_cache,
                         gen_cache, prompt_bias, t: int, kb: int):
    """One beam decode step over the cast params ``p`` (``lm.py:491-523``):
    ``tok`` (B*K, 1) at ``positions`` (B*K, 1) writes each beam's k/v into
    slot ``t`` of its generation-cache row and attends over its batch
    row's prompt cache and slots [0, t]. -> (B*K, V) f32 logits."""
    x = _embed_in(p, cfg, tok, positions)
    bk = x.shape[0]
    (nh, nkv), hd = cfg.local_heads, cfg.head_dim
    b = bk // kb
    tp = _tp(cfg, "attn")
    if cfg.arch != "gpt2":  # every layer rotates at the same positions
        angles = _rope_angles(positions, hd // 2, cfg.rope_theta)
    for layer, pkv, (gk, gv) in zip(p["layers"], prompt_cache, gen_cache):
        if cfg.arch == "gpt2":
            h = _layer_norm(x, layer["ln1_s"], layer["ln1_b"], GPT2_LN_EPS)
            qkv = h @ layer["qkv_w"] + layer["qkv_b"]
            q, k, v = (u.reshape(bk, nh, hd)
                       for u in qkv[:, 0].split(cfg.hidden, dim=-1))
            gk[t], gv[t] = k, v
            ctx = _beam_attend(q.reshape(b, kb, nh, 1, hd), pkv, gk, gv,
                               prompt_bias, t, x.dtype)
            x = x + _gpt2_out(layer, cfg, ctx)
            x = x + _gpt2_mlp(layer, x)
            continue
        h = _rms_norm(x, layer["attn_norm"], cfg.rms_eps)
        if tp is not None:
            h = copy_to_group(h, tp.group)
        q = _rope((h @ layer["q_w"]).reshape(bk, 1, nh, hd), positions,
                  cfg.rope_theta, angles)
        k = _rope((h @ layer["k_w"]).reshape(bk, 1, nkv, hd), positions,
                  cfg.rope_theta, angles)
        gk[t], gv[t] = k[:, 0], (h @ layer["v_w"]).reshape(bk, nkv, hd)
        ctx = _beam_attend(q.reshape(b, kb, nkv, nh // nkv, hd), pkv, gk,
                           gv, prompt_bias, t, x.dtype)
        x = x + _row_out(ctx @ layer["o_w"], tp)
        x = x + _mlp(layer, _rms_norm(x, layer["mlp_norm"], cfg.rms_eps),
                     _tp(cfg, "mlp"))
    return _full_vocab(cfg, _unembed(p, cfg, x[:, -1]))


def _beam_search(p, cfg: LMConfig, input_ids, attention_mask, *,
                 max_new_tokens: int, eos_id: int, pad_id: int,
                 num_beams: int, length_penalty: float, min_new_tokens: int,
                 forced_prefix, forced_len) -> BeamResult:
    """The search of :func:`beam_generate` over the cast params ``p``."""
    b, plen = input_ids.shape
    kb, t_max = num_beams, max_new_tokens
    dev = input_ids.device
    f32 = torch.float32

    # prefill on the B prompt rows; the K beams of a row share its cache
    positions = positions_from_mask(attention_mask)
    prompt_cache = init_cache(cfg, b, plen, dev)
    logits = _forward_with_cache(p, cfg, input_ids, attention_mask,
                                 positions, prompt_cache, 0, plen)
    # the attention reads the prompt's k/v in f32 every step: upcast once
    prompt_cache = [(k.to(torch.float32), v.to(torch.float32))
                    for k, v in prompt_cache]
    vocab = logits.shape[-1]
    logits = logits[:, None].expand(b, kb, vocab)
    prompt_bias = torch.where(attention_mask.bool(), 0.0, BEAM_NEG).to(f32)
    next_pos = positions[:, -1] + 1
    # the generation cache, time-major (T, B*K, kv, hd) a layer, and a
    # second one that each step's reorder gathers into (then the two swap)
    shape = (t_max, b * kb, cfg.local_heads[1], cfg.head_dim)

    def caches():
        return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 torch.zeros(shape, dtype=cfg.dtype, device=dev))
                for _ in range(cfg.layers)]
    gen, spare = caches(), caches()

    run_scores = torch.full((b, kb), BEAM_NEG, dtype=f32, device=dev)
    run_scores[:, 0] = 0.0  # beam 0 only: the others start masked
    seqs = torch.full((b, kb, t_max), pad_id, dtype=torch.long, device=dev)
    lp_seqs = torch.zeros((b, kb, t_max), dtype=f32, device=dev)
    fin_seqs, fin_lps = seqs.clone(), lp_seqs.clone()
    fin_scores = torch.full((b, kb), BEAM_NEG, dtype=f32, device=dev)
    is_fin = torch.zeros((b, kb), dtype=torch.bool, device=dev)
    unsat = torch.ones((b,), dtype=torch.bool, device=dev)
    live = torch.ones((), dtype=torch.bool, device=dev)  # some row unsat
    steps = torch.zeros((), dtype=torch.long, device=dev)
    top_ranks = torch.arange(2 * kb, device=dev) < kb  # only these finish
    row0 = torch.arange(b, device=dev)[:, None] * kb
    vocab_ids = torch.arange(vocab, device=dev)

    def take(x, sel):  # (B, N, ...) rows ``sel`` (B, M) of each batch row
        return torch.gather(x, 1, sel.reshape(*sel.shape, *(1,) * (
            x.dim() - 2)).expand(*sel.shape, *x.shape[2:]))

    for t in range(t_max):
        logp = torch.log_softmax(logits.to(f32), dim=-1)
        if t < min_new_tokens and eos_id >= 0:
            logp[..., eos_id] = -torch.inf
        if forced_prefix is not None:
            forced_t = forced_prefix[:, min(t, forced_prefix.shape[1] - 1)]
            ban = ((t < forced_len)[:, None, None]
                   & (vocab_ids != forced_t.long()[:, None, None]))
            logp = logp.masked_fill(ban, -torch.inf)
        acc = (run_scores[:, :, None] + logp).reshape(b, kb * vocab)
        cand_scores, cand_idx = top_k_lax(acc, 2 * kb)  # (B, 2K)
        src, tok = cand_idx // vocab, cand_idx % vocab
        cand_seqs = take(seqs, src)
        cand_seqs[:, :, t] = tok
        # this step's token log-prob: acc = run + logp, so the increment is
        # the candidate's score less its source beam's
        cand_lps = take(lp_seqs, src)
        cand_lps[:, :, t] = cand_scores - torch.gather(run_scores, 1, src)
        hits = (tok == eos_id) | (t == t_max - 1)

        # the running beams (HF keeps the masked score)
        run_scores, sel = top_k_lax(cand_scores + hits.to(f32) * BEAM_NEG,
                                    kb)
        seqs, lp_seqs = take(cand_seqs, sel), take(cand_lps, sel)
        sel_src = torch.gather(src, 1, sel)
        sel_tok = torch.gather(tok, 1, sel)

        # the finished set; frozen once the JAX loop would have exited
        denom = _length_norm(t + 1, length_penalty)
        did_finish = hits & top_ranks
        gated = torch.where(did_finish & unsat[:, None], cand_scores / denom,
                            BEAM_NEG)
        new_scores, fsel = top_k_lax(torch.cat([fin_scores, gated], 1), kb)
        fin_scores = torch.where(live, new_scores, fin_scores)
        fin_seqs = torch.where(live, take(torch.cat([fin_seqs, cand_seqs], 1),
                                          fsel), fin_seqs)
        fin_lps = torch.where(live, take(torch.cat([fin_lps, cand_lps], 1),
                                         fsel), fin_lps)
        is_fin = torch.where(live, take(torch.cat([is_fin, did_finish], 1),
                                        fsel), is_fin)
        # HF's early-stop heuristic at the incremented length
        best = run_scores[:, :1] / denom
        worst = torch.where(is_fin, fin_scores.min(1, keepdim=True).values,
                            BEAM_NEG)
        unsat = unsat & (~live | (best > worst).any(1))
        steps = steps + live.long()
        live = live & unsat.any()
        if t + 1 == t_max or ((t + 1) % EXIT_CHECK_EVERY == 0
                              and not bool(live)):
            break

        # beam reorder: gather each new beam's history from its source
        # beam's row into the spare cache (slots [0, t)), then swap
        if t > 0:
            rows = (row0 + sel_src).reshape(-1)
            for (ck, cv), (sk, sv) in zip(gen, spare):
                torch.index_select(ck[:t], 1, rows, out=sk[:t])
                torch.index_select(cv[:t], 1, rows, out=sv[:t])
            gen, spare = spare, gen
        pos = (next_pos + t).repeat_interleave(kb)[:, None]
        logits = _beam_decode_forward(
            p, cfg, sel_tok.reshape(b * kb, 1), pos, prompt_cache, gen,
            prompt_bias, t, kb).reshape(b, kb, vocab)
    return BeamResult(fin_seqs[:, 0], fin_lps[:, 0], fin_scores[:, 0], steps)


def beam_generate(params: dict, cfg: LMConfig, input_ids, attention_mask,
                  *, max_new_tokens: int, eos_id: int, pad_id: int,
                  num_beams: int, length_penalty: float = 1.0,
                  min_new_tokens: int = 0, forced_prefix=None,
                  forced_len=None, return_logprobs: bool = False):
    """Beam-search decode (``lm.py:645-834``): transformers' vectorised
    ``_beam_search`` with ``do_sample=False, early_stopping=False``.

    - 2 * ``num_beams`` candidates a step, taken in ``lax.top_k``'s order
      (``top_k_lax``), as are the running beams and the finished-set merge;
    - only the top ``num_beams`` candidate ranks may finish, on EOS or at
      the last step, with score ``sum_logprob / (t + 1) **
      length_penalty``;
    - the running beams carry the -1e9 mask of the candidates that
      finished; each batch row's finished set stops taking candidates once
      HF's early-stop heuristic holds (the best running score at the
      current length against the worst finished one);
    - ``min_new_tokens`` pins EOS to -inf for the first steps;
      ``forced_prefix``/``forced_len`` allow only each row's forced token
      while ``t < forced_len``;
    - the search stops once no row is unsatisfied. The host reads that
      flag every ``EXIT_CHECK_EVERY`` steps; the steps in between leave
      the finished sets as they were, so the output is that of an exit at
      the first such step.

    The cache: the prompt's k/v are computed once per batch row and shared
    by its K beams (never repeated K times). Each beam's generation k/v sit
    in its own row of a (T, B*K, kv, hd) cache a layer, and a beam reorder
    gathers the filled slots [0, t) into a second buffer (then the two
    swap). The JAX package instead keeps the rows in place and attends
    through a (B, K, T) ancestry matrix, scoring every beam against all K
    physical rows and selecting with a one-hot einsum; both are exact
    selections. The gather reads and writes the filled slots once a step,
    a cost of the same order as the attention's own read of them; the
    one-hot selection needs a (B, K, heads, K, T) weight tensor each layer
    and step, and the gather keeps the attention the greedy path's plain
    contraction.

    ``input_ids`` must be LEFT-padded. Returns the (B, max_new_tokens)
    int64 ids of each row's best finished hypothesis (EOS included, pad
    after); with ``return_logprobs`` also their (B, max_new_tokens) f32
    log-probs, each ``cand_score - run_score[src]`` (no second scoring
    forward), 0 in the pad tail."""
    _check_decodes(cfg)
    p = _cast_params(params, cfg)
    with torch.no_grad():
        out = _beam_search(p, cfg, input_ids, attention_mask,
                           max_new_tokens=max_new_tokens, eos_id=eos_id,
                           pad_id=pad_id, num_beams=num_beams,
                           length_penalty=length_penalty,
                           min_new_tokens=min_new_tokens,
                           forced_prefix=forced_prefix,
                           forced_len=forced_len)
    if return_logprobs:
        return out.ids, out.logprobs
    return out.ids
