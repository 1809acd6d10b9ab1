"""BERT encoder for dense retrieval as ``nn.Module``s.

Counterpart of ``jsa_rag_tpu/models/bert.py`` (:104-219) with the same
numerics: LayerNorm in f32 whatever the activation dtype, exact (erf) gelu,
a -1e9 additive attention mask, attention logits accumulated in f32, and
token / position lookups clipped into range (``jnp.take(mode="clip")``:
an id or position past the table reads its last row instead of NaN).

Parameters keep the JAX package's key names and its (in, out) weight layout
(``x @ w``), so ``convert.py`` moves a numpy pytree into either package:
``embed.{word,position,type,ln_scale,ln_bias}`` and
``layers.<i>.{q,k,v,o}_{w,b}``, ``attn_ln_{scale,bias}``,
``ffn_{in,out}_{w,b}``, ``ffn_ln_{scale,bias}``.

Training (``bert.py:96-196``): with ``cfg.dropout > 0`` and an ``rng`` (a
CPU ``torch.Generator``), dropout runs at HF BERT's places — the embeddings,
the attention probabilities, the attention output and the FFN output — each
layer's masks drawn from seeds taken from ``rng`` up front, as the JAX
package splits its key; a forward without ``rng`` is deterministic.
``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``); the seeds
travel into the checkpointed call, so the recomputation draws the same masks.

Attention: on a CUDA device, a bf16 or fp16 forward that records no gradient
and draws no dropout (an index build's passage tower, served and evaluated
queries) runs one hand-written kernel a layer (``ops/bert_attention.py``);
every other forward takes the composed ``_attention_plain``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint
from torch import nn

from ..ops.bert_attention import _attention_plain, bert_attention
from ..utils import trace

# geometry presets, copied from jsa_rag_tpu/model_io.py:35-43
BERT_PRESETS = {
    "tiny": dict(hidden=64, layers=2, heads=4, intermediate=128),
    "small": dict(hidden=256, layers=4, heads=8, intermediate=512),
    "base": dict(hidden=768, layers=12, heads=12, intermediate=3072),
    # bge-large-en geometry — the flagship retriever tower
    "large": dict(hidden=1024, layers=24, heads=16, intermediate=4096),
}

POOLINGS = ("cls", "cls_norm", "mean", "mean_norm", "sqrt")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    pooling: str = "mean"  # cls | cls_norm | mean | mean_norm | sqrt
    dtype: torch.dtype = torch.float32  # activation dtype
    remat: bool = False  # per-layer activation recomputation
    dropout: float = 0.0  # train-time rate; active only with an rng

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def _param(shape, init: str = "normal", *, device, generator):
    """N(0, 0.02) weights, zero biases, unit LayerNorm scales. Without a
    generator the weights start at zero, to be loaded."""
    if init == "ones":
        t = torch.ones(shape, device=device)
    elif init == "normal" and generator is not None:
        t = 0.02 * torch.randn(shape, generator=generator, device=device)
    else:
        t = torch.zeros(shape, device=device)
    return nn.Parameter(t)


def split_seeds(rng: torch.Generator | None, n: int) -> list:
    """n dropout seeds drawn from the CPU generator ``rng`` (the JAX
    package's ``jax.random.split``), or n Nones without one."""
    if rng is None:
        return [None] * n
    return torch.randint(0, 2 ** 62, (n,), generator=rng).tolist()


def dropout(x, rate: float, seed: int | None):
    """Inverted dropout with its mask drawn from a generator seeded by
    ``seed`` on ``x``'s device; identity when ``seed`` is None or
    ``rate == 0``."""
    if seed is None or rate == 0.0:
        return x
    with trace.span("dropout.mask"):
        g = torch.Generator(device=x.device).manual_seed(seed)
        keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _layer_norm(x, scale, bias, eps):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        p = functools.partial(_param, device=device, generator=generator)
        self.word = p((cfg.vocab_size, cfg.hidden))
        self.position = p((cfg.max_positions, cfg.hidden))
        # nn.Module.type is a method, so the token-type table keeps its
        # JAX name by sitting in _parameters directly (read via .type_table)
        self._parameters["type"] = p((cfg.type_vocab, cfg.hidden))
        self.ln_scale = p((cfg.hidden,), "ones")
        self.ln_bias = p((cfg.hidden,), "zeros")

    @property
    def type_table(self) -> nn.Parameter:
        return self._parameters["type"]


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__()
        h, f = cfg.hidden, cfg.intermediate
        p = functools.partial(_param, device=device, generator=generator)
        for name in ("q", "k", "v", "o"):
            setattr(self, f"{name}_w", p((h, h)))
            setattr(self, f"{name}_b", p((h,), "zeros"))
        self.attn_ln_scale = p((h,), "ones")
        self.attn_ln_bias = p((h,), "zeros")
        self.ffn_in_w = p((h, f))
        self.ffn_in_b = p((f,), "zeros")
        self.ffn_out_w = p((f, h))
        self.ffn_out_b = p((h,), "zeros")
        self.ffn_ln_scale = p((h,), "ones")
        self.ffn_ln_bias = p((h,), "zeros")
        self.cfg = cfg

    def _attention(self, x, bias, seed=None):
        cfg = self.cfg
        b, s, h = x.shape
        nh, hd = cfg.heads, cfg.head_dim

        def proj(w, bb):
            return (x @ w.to(x.dtype) + bb.to(x.dtype)).reshape(b, s, nh, hd)

        q = proj(self.q_w, self.q_b)
        k = proj(self.k_w, self.k_b)
        v = proj(self.v_w, self.v_b)
        # the fused kernel where nothing records a gradient or draws dropout
        if (x.is_cuda and seed is None
                and x.dtype in (torch.bfloat16, torch.float16)
                and not (q.requires_grad or k.requires_grad
                         or v.requires_grad)):
            ctx = bert_attention(q, k, v, bias)
        else:
            ctx = _attention_plain(
                q, k, v, bias, lambda p: dropout(p, cfg.dropout, seed))
        return ctx @ self.o_w.to(x.dtype) + self.o_b.to(x.dtype)

    def _ffn(self, x):
        h = x @ self.ffn_in_w.to(x.dtype) + self.ffn_in_b.to(x.dtype)
        h = torch.nn.functional.gelu(h, approximate="none")
        return h @ self.ffn_out_w.to(x.dtype) + self.ffn_out_b.to(x.dtype)

    def forward(self, x, bias, seeds=(None, None, None)):
        """``seeds``: the (attention probs, attention output, FFN output)
        dropout seeds."""
        cfg = self.cfg
        a = dropout(self._attention(x, bias, seeds[0]), cfg.dropout,
                    seeds[1])
        x = _layer_norm(x + a, self.attn_ln_scale, self.attn_ln_bias,
                        cfg.ln_eps)
        f = dropout(self._ffn(x), cfg.dropout, seeds[2])
        return _layer_norm(x + f, self.ffn_ln_scale, self.ffn_ln_bias,
                           cfg.ln_eps)


class BertEncoder(nn.Module):
    """(B, S) token ids + mask -> pooled (B, H) embeddings."""

    def __init__(self, cfg: BertConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {cfg.pooling!r}")
        self.cfg = cfg
        self.embed = BertEmbeddings(cfg, device, generator)
        self.layers = nn.ModuleList(
            BertLayer(cfg, device, generator) for _ in range(cfg.layers))

    def hidden(self, input_ids, attention_mask, rng=None) -> torch.Tensor:
        """Last-layer hidden states, (B, S, H); ``rng`` (a CPU generator)
        turns on train-time dropout."""
        cfg = self.cfg
        emb = self.embed
        s = input_ids.shape[1]
        ids = input_ids.long().clamp(0, cfg.vocab_size - 1)
        pos = torch.arange(s, device=ids.device).clamp(
            max=cfg.max_positions - 1)
        x = (emb.word[ids] + emb.position[pos][None]
             + emb.type_table[0][None, None])
        x = _layer_norm(x, emb.ln_scale, emb.ln_bias, cfg.ln_eps)
        x = x.to(cfg.dtype)
        bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0,
                           -1e9).to(torch.float32)
        seeds = split_seeds(rng if cfg.dropout > 0.0 else None,
                            1 + 3 * cfg.layers)
        x = dropout(x, cfg.dropout, seeds[0])
        for i, layer in enumerate(self.layers):
            lseeds = tuple(seeds[1 + 3 * i:4 + 3 * i])
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, bias, lseeds, use_reentrant=False)
            else:
                x = layer(x, bias, lseeds)
        return x

    def forward(self, input_ids, attention_mask, rng=None) -> torch.Tensor:
        return pool(self.hidden(input_ids, attention_mask, rng),
                    attention_mask, self.cfg.pooling)


def pool(hidden: torch.Tensor, attention_mask, pooling: str) -> torch.Tensor:
    """Sequence -> embedding pooling (``bert.py::pool``)."""
    mask = attention_mask.to(hidden.dtype)[..., None]
    if pooling in ("cls", "cls_norm"):
        out = hidden[:, 0]
    elif pooling in ("mean", "mean_norm"):
        out = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)
    elif pooling == "sqrt":
        out = (hidden * mask).sum(dim=1) / torch.sqrt(
            mask.sum(dim=1).clamp_min(1e-9))
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    if pooling.endswith("_norm"):
        out = out / torch.linalg.vector_norm(
            out.to(torch.float32), dim=-1, keepdim=True).clamp_min(
                1e-12).to(out.dtype)
    return out
