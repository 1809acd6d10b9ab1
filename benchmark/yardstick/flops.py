"""Operations and bytes of the work a cell asks for, counted from the shapes
of the rows it actually ran (real tokens, no padding) and never from a
kernel: the count reads the same whatever implements the work. A
multiply-add is two operations. ``PERF.md`` writes each formula out.

Configurations are the HF-style dicts of ``configs/*.json`` (``generator``
and ``retriever`` groups).
"""

from __future__ import annotations

from collections.abc import Iterable


# ------------------------------------------------------------- generator
def lm_layer_params(c: dict) -> int:
    """Weights of one llama-family block's projections (q, k, v, o, gate,
    up, down)."""
    h, hd = c["hidden_size"], c["head_dim"]
    nh, nkv, f = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["intermediate_size"])
    return h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * f


def lm_forward_flops(c: dict, tokens: int, labels: int) -> float:
    """Forward of one sequence of ``tokens`` real tokens whose ``labels``
    positions are scored: the projections of every layer, causal attention
    (each query against itself and the keys before it: QK^T and PV), and
    the head at the scored positions only (the loss reads no other)."""
    nh, hd, n_layers = (c["num_attention_heads"], c["head_dim"],
                        c["num_hidden_layers"])
    body = 2 * lm_layer_params(c) * tokens
    attn = 2 * nh * hd * tokens * (tokens + 1)  # QK^T + PV, causal
    head = 2 * c["hidden_size"] * c["vocab_size"] * labels
    return float(n_layers * (body + attn) + head)


def lora_forward_flops(c: dict, rank: int, tokens: int) -> float:
    """The adapters' x A and (x A) B of every target of every layer."""
    h, hd = c["hidden_size"], c["head_dim"]
    nh, nkv, f = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["intermediate_size"])
    in_out = [(h, nh * hd), (h, nkv * hd), (h, nkv * hd), (nh * hd, h),
              (h, f), (h, f), (f, h)]
    per_token = sum(2 * rank * (i + o) for i, o in in_out)
    return float(c["num_hidden_layers"] * per_token * tokens)


def lm_lora_train_flops(c: dict, rank: int, tokens: int,
                        labels: int) -> float:
    """One sequence of a LoRA step: the generator's forward and its backward
    to the activations only (the frozen base takes no weight gradient; the
    backward of a product to its input costs what the forward did, and
    attention's backward to Q, K and V twice its forward), plus the
    adapters' forward and backward (three times their forward). No
    recomputation is counted."""
    nh, hd, n_layers = (c["num_attention_heads"], c["head_dim"],
                        c["num_hidden_layers"])
    attn = n_layers * 2 * nh * hd * tokens * (tokens + 1)
    fwd = lm_forward_flops(c, tokens, labels)
    bwd = (fwd - attn) + 2 * attn
    return float(fwd + bwd + 3 * lora_forward_flops(c, rank, tokens))


# -------------------------------------------------------------- BERT tower
def bert_forward_flops(c: dict, tokens: int) -> float:
    """One sequence of ``tokens`` real tokens through a BERT tower: the four
    attention projections and the FFN of every layer, and full
    (bidirectional) attention, QK^T and PV. Embedding lookups, LayerNorm
    and pooling are not counted."""
    h, f, n_layers = (c["hidden_size"], c["intermediate_size"],
                      c["num_hidden_layers"])
    body = 2 * (4 * h * h + 2 * h * f) * tokens
    attn = 4 * h * tokens * tokens
    return float(n_layers * (body + attn))


def bert_train_flops(c: dict, tokens: int) -> float:
    """Forward and backward (weights trained: twice the forward) of one
    sequence."""
    return 3.0 * bert_forward_flops(c, tokens)


# ------------------------------------------------------------------ search
def int8r_search_ops(b: int, n: int, d: int, k: int, refine: int) -> dict:
    """The work of one top-k search of ``b`` queries over ``n`` int8r rows
    of width ``d``: the coarse scan's products of both query planes with
    plane 1 of every row (int8), and the refine's f32 products of each
    query with plane 2 of its ``refine * k`` candidates.
    -> {"int8": ops, "f32": ops}."""
    return {"int8": 2.0 * 2 * b * n * d,
            "f32": 2.0 * b * refine * k * d}


def int8r_search_bytes(b: int, n: int, d: int, k: int,
                       refine: int) -> float:
    """Bytes a search must move at least: plane 1 and its row scales read
    once, the plane-2 rows of the candidates and their scales, the f32
    queries in, the (scores, ids) out."""
    return float(n * d + 4 * n + b * refine * k * (d + 4) + 4 * b * d
                 + 8 * b * k)


def b1_scan_work(b: int, n: int, d: int, tile_n: int,
                 t_per_tile: int) -> tuple[float, float]:
    """Kernel B1 (``csrc/topt_int8r2.cu``) over ``n`` valid rows: (int8 ops,
    bytes). Ops: both query planes against plane 1 of every row. Bytes:
    plane 1 and its scales read once, the two int8 query planes and their
    scales read once, the (n_tiles, b, T) scores and ids written once."""
    n_tiles = -(-n // tile_n)
    ops = 2.0 * 2 * b * n * d
    n_bytes = n * d + 4 * n + 2 * b * d + 8 * b + 8 * n_tiles * b * t_per_tile
    return ops, float(n_bytes)


def total(xs: Iterable[float]) -> float:
    return float(sum(xs))
