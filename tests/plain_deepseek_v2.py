"""DeepSeek-V2's decoder as published (HF ``modeling_deepseek.py``,
DeepSeek-V2-Lite's ``config.json``), plain float32 torch, TF32 off: the
forward pass, the per-row generator loss of jsa training (``row_ce``) and,
through autograd, its gradients. It imports no kernel and nothing of the
program under test; the weights are the leaf tree the program reads
(``embed``, ``layers[i]``, ``final_norm``, ``lm_head``; matrices (in, out),
expert stacks (E, in, out)), held in any dtype and upcast one layer at a
time.

Each layer: RMSNorm, multi-head latent attention without a query latent
(``q_proj``; ``kv_a_proj_with_mqa`` to the latent and one rope key;
``kv_a_layernorm``; ``kv_b_proj`` to each head's nope key and value), the
rope parts rotated as HF does (viewed as (half, 2), transposed, then
``rotate_half``) with YaRN's frequencies and cos/sin factor, logits scaled
by ``qk_head_dim^-0.5 * m(mscale_all_dim)^2``; then RMSNorm and the dense
SwiGLU (the first ``first_k_dense_replace`` layers) or the MoE: a softmax
router in f32, the greedy top ``num_experts_per_tok``, each routed expert's
SwiGLU weighted by its router probability (times ``routed_scaling_factor``;
``norm_topk_prob`` false), plus the shared experts. No grouping: a loop
over the experts, each over the tokens routed to it. LoRA adapters are
added unmerged, as peft computes them: ``x W + scale (x A) B``.

Departures from the published model:

- the sequence-level auxiliary balance loss (``seq_aux``) is left out: it
  is a training term whose coefficient the config does not give, and it
  moves no forward number;
- attention dropout (``drop``) takes the masks given, one site a layer
  (the published config has none; a recipe's ``--dropout`` maps onto the
  attention probabilities);
- ``routes`` (where given) fixes the experts each real token takes, layer
  by layer, to another run's choices; the weights stay this reference's own
  probabilities of those experts. ``route_faults`` counts the (token,
  layer) pairs whose own top-k set differs from the given one while its
  own k-th and (k+1)-th probabilities lie more than ``margin`` apart.
  ``taken`` (a list, where given) receives the experts each MoE layer
  took and their router probabilities, in the forward.

``mm`` carries every product (``.mm(a, b)``, ``.einsum(eq, a, b)``); the
default is float32.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint


class F32:
    """float32 products."""

    @staticmethod
    def mm(a, b):
        return a.to(torch.float32) @ b.to(torch.float32)

    @staticmethod
    def einsum(eq, a, b):
        return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------- YaRN
def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base=10000,
                             max_position_embeddings=2048):
    return (dim * math.log(max_position_embeddings
                           / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base=10000,
                               max_position_embeddings=2048):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base,
                                              max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base,
                                              max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def yarn_linear_ramp_mask(lo, hi, dim):
    if lo == hi:
        hi += 0.001
    linear = (torch.arange(dim, dtype=torch.float32) - lo) / (hi - lo)
    return torch.clamp(linear, 0, 1)


def inv_freq(c: dict) -> torch.Tensor:
    """The rotary's inverse frequencies (``DeepseekV2YarnRotaryEmbedding``;
    plain rotary without ``rope_scaling``)."""
    dim, base = c["qk_rope_head_dim"], float(c["rope_theta"])
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    rs = c.get("rope_scaling")
    if not rs:
        return extra
    factor = rs["factor"]
    inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2,
                                                  dtype=torch.float32) / dim))
    low, high = yarn_find_correction_range(
        rs["beta_fast"], rs["beta_slow"], dim, base,
        rs["original_max_position_embeddings"])
    mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2)
    return inter * (1 - mask) + extra * mask


def cos_sin(c: dict, positions: torch.Tensor):
    """(cos, sin) (B, S, rope dim) at ``positions`` (B, S), times YaRN's
    ``m(mscale) / m(mscale_all_dim)``."""
    rs = c.get("rope_scaling")
    m = 1.0
    if rs:
        m = (yarn_get_mscale(rs["factor"], rs["mscale"])
             / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]))
    freqs = positions[..., None].float() * inv_freq(c).to(positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * m, emb.sin() * m


def softmax_scale(c: dict) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rotate_half(x):
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rope(x, cos, sin):
    """x (B, N, S, D): HF's interleaved-pair view, then ``rotate_half``."""
    b, n, s, d = x.shape
    x = x.view(b, n, s, d // 2, 2).transpose(4, 3).reshape(b, n, s, d)
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


# ---------------------------------------------------------------- pieces
def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * scale.float()


def _lin(x, w, ab, scale, mm):
    """x W (+ scale (x A) B)."""
    y = mm.mm(x, w.float())
    if ab is not None:
        y = y + scale * mm.mm(mm.mm(x, ab["A"]), ab["B"])
    return y


def _swiglu(x, base, lora, scale, mm, prefix=""):
    def lin(t, name):
        return _lin(t, base[prefix + name], None if lora is None
                    else lora.get(prefix + name), scale, mm)

    return lin(torch.nn.functional.silu(lin(x, "gate_w")) * lin(x, "up_w"),
               "down_w")


def _expert(x, base, lora, scale, mm, e):
    """Routed expert ``e``'s SwiGLU of the rows ``x``."""
    def lin(t, name):
        ab = None
        if lora is not None and name in lora:
            ab = {"A": lora[name]["A"][e], "B": lora[name]["B"][e]}
        return _lin(t, base[name][e], ab, scale, mm)

    g = lin(x, "experts_gate_w")
    return lin(torch.nn.functional.silu(g) * lin(x, "experts_up_w"),
               "experts_down_w")


def router_probs(h, base, mm):
    """(T, E) f32 router probabilities of the rows ``h`` (T, H)."""
    return torch.softmax(mm.mm(h.float(), base["router_w"].float()), dim=-1)


def _moe(x, base, lora, c, scale, mm, route=None, margin=None):
    """x (T, H) -> (the layer's output (T, H), route faults, (the experts
    taken (T, k), their router probabilities (T, k)))."""
    k = c["num_experts_per_tok"]
    probs = router_probs(x, base, mm)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    faults = 0
    ids = top_i
    if route is not None:
        given, real = route
        ids = torch.where(real[:, None], given, top_i)
        if margin is not None:
            kth = torch.topk(probs.detach(), k + 1, dim=-1).values
            gap = kth[:, k - 1] - kth[:, k]
            own = torch.sort(top_i, dim=-1).values
            other = torch.sort(given, dim=-1).values
            faults = int((real & (gap > margin)
                          & (own != other).any(dim=-1)).sum())
    taken = torch.gather(probs, 1, ids)
    weights = taken * c["routed_scaling_factor"]
    if c.get("norm_topk_prob"):
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    out = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _expert(x[tok], base, lora, scale, mm, e)
        out = out.index_add(0, tok, y * weights[tok, slot][:, None])
    return (out + _swiglu(x, base, lora, scale, mm, "shared_"), faults,
            (ids, taken.detach()))


def _block(base, lora, x, pos, bias, c, mm, scale, i=0, drop=None,
           route=None, margin=None):
    """One decoder layer -> (x, route faults, the experts taken and their
    router probabilities, or None)."""
    b, s, h = x.shape
    nh = c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    r, eps = c["kv_lora_rank"], c["rms_norm_eps"]

    def lin(t, name):
        return _lin(t, base[name], None if lora is None else lora.get(name),
                    scale, mm)

    y = _rms(x, base["attn_norm"], eps)
    q = lin(y, "q_w").view(b, s, nh, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = lin(y, "kv_a_w")
    latent, k_pe = ckv[..., :r], ckv[..., r:].view(b, s, 1, dr).transpose(1, 2)
    kv = lin(_rms(latent, base["kv_norm"], eps), "kv_b_w")
    kv = kv.view(b, s, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = pos
    q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe, cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, nh, s, dr)], dim=-1)
    logits = mm.einsum("bnqd,bnkd->bnqk", query, key) * softmax_scale(c) \
        + bias
    probs = torch.softmax(logits, dim=-1)
    if drop is not None:
        probs = drop.apply(i, probs, range(b))
    ctx = mm.einsum("bnqk,bnkd->bqnd", probs, v).reshape(b, s, nh * dv)
    x = x + lin(ctx, "o_w")
    y = _rms(x, base["mlp_norm"], eps).reshape(b * s, h)
    if "router_w" in base:
        out, faults, taken = _moe(y, base, lora, c, scale, mm, route,
                                  margin)
    else:
        out, faults, taken = _swiglu(y, base, lora, scale, mm), 0, None
    return x + out.reshape(b, s, h), faults, taken


def hidden(weights: dict, lora: dict | None, c: dict, ids, mask, mm=F32,
           lora_scale: float = 1.0, drop=None, routes=None, margin=None,
           checkpoint: bool = True, taken=None):
    """(R, S) right-padded rows -> (final-normed hidden states (R, S, H)
    f32, route faults). ``routes``: one (R * S, k) id tensor an MoE layer,
    or None."""
    s = ids.shape[1]
    positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=ids.device))
    bias = torch.where(causal[None, None] & mask[:, None, None, :].bool(),
                       0.0, -1e9)
    pos = cos_sin(c, positions)
    real = mask.reshape(-1).bool()
    x = weights["embed"][ids.long()].float()
    faults, moe = 0, 0
    for i, base in enumerate(weights["layers"]):
        lo = None if lora is None else lora["layers"][i]
        route = None
        if "router_w" in base:
            if routes is not None:
                route = (routes[moe].to(ids.device).long(), real)
            moe += 1
        args = (base, lo, x, pos, bias, c, mm, lora_scale, i, drop, route,
                margin)
        if checkpoint and torch.is_grad_enabled():
            # the faults are counted in the forward; the recompute's
            # count is dropped
            box = []

            def run(*a):
                y, f, t = _block(*a)
                box.append((f, t))
                return y
            x = torch.utils.checkpoint.checkpoint(run, *args,
                                                  use_reentrant=False)
            f, t = box[0]
        else:
            x, f, t = _block(*args)
        faults += f
        if taken is not None and t is not None:
            taken.append((t[0].detach(), t[1]))
    return _rms(x, weights["final_norm"], c["rms_norm_eps"]), faults


def logits(weights: dict, lora: dict | None, c: dict, ids, mask, mm=F32,
           lora_scale: float = 1.0):
    """(R, S) -> (R, S, V) f32 logits."""
    x, _ = hidden(weights, lora, c, ids, mask, mm, lora_scale,
                  checkpoint=False)
    return mm.mm(x, weights["lm_head"].float())


def lm_loss(weights: dict, lora: dict | None, c: dict, ids, mask, labels,
            mm=F32, lora_scale: float = 1.0):
    """Mean over rows of the length-normalised next-token CE."""
    return row_ce(weights, lora, c, ids, mask, labels, mm, lora_scale)[0] \
        .mean()


def row_ce(weights: dict, lora: dict | None, c: dict, ids, mask, labels,
           mm=F32, lora_scale: float = 1.0, logit_temp: float = 1.0,
           drop=None, routes=None, margin=None, taken=None):
    """The reference recipe's per-candidate generator loss
    (``src/rag.py:1338-1366``): (R, S) right-padded rows -> ((R,)
    length-normalised CE over the target tokens (labels -100 elsewhere;
    the logits at t score the token at t + 1), route faults). Each layer is
    recomputed in the backward pass."""
    x, faults = hidden(weights, lora, c, ids, mask, mm, lora_scale, drop,
                       routes, margin, taken=taken)
    targets = labels[:, 1:].long()
    valid = targets != -100
    rows, cols = torch.nonzero(valid, as_tuple=True)
    out = mm.mm(x[:, :-1][rows, cols], weights["lm_head"].float())
    logp = torch.log_softmax(out / logit_temp, dim=-1)
    tok = logp.gather(1, targets[rows, cols][:, None])[:, 0]
    nll = torch.zeros(ids.shape[0], dtype=torch.float32,
                      device=ids.device).index_add(0, rows, -tok)
    return nll / valid.sum(dim=1).clamp_min(1), faults
