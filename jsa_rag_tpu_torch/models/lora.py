"""LoRA: low-rank adapter overlay on the generator's parameter dict.

Counterpart of ``jsa_rag_tpu/models/lora.py`` (:20-82): the adapter tree
mirrors the base tree at the targeted weight leaves,
``{"layers": [{name: {"A": (in, r), "B": (r, out)}}]}``, and ``lora_apply``
materialises ``W + (alpha/rank) * A @ B`` with every base leaf detached (the
JAX package's stop_gradient), so a backward pass reaches A and B only.

A stacked leaf (deepseek_v2's routed experts, (E, in, out)) takes one
adapter an expert, ``{"A": (E, in, r), "B": (E, r, out)}``, and stays
unmerged: ``lora_apply`` leaves the stack as it is and hands the adapter to
the forward under the layer's ``"adapters"`` key, which adds ``scale (x
A_e) B_e`` to each expert's product (``models/lm.py::_grouped``). Merging
would write a second copy of every expert and a full-shape gradient of it;
the 2-D leaves of every architecture stay merged.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    # the reference's llama/mistral targets (src/model_io.py:160-168) plus
    # the gpt2 family's names and deepseek_v2's leaves that peft's
    # q/k/v/o/gate/up/down_proj names match (q_proj and o_proj of latent
    # attention, which has no k_proj or v_proj; the dense MLP, the shared
    # experts and every routed expert; not the router, ``mlp.gate``);
    # lora_init matches by presence. The routed experts' stacks
    # (experts_*) are applied unmerged, every other leaf merged
    targets: tuple[str, ...] = (
        "q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w",
        "qkv_w", "fc_w", "proj_w",
        "shared_gate_w", "shared_up_w", "shared_down_w",
        "experts_gate_w", "experts_up_w", "experts_down_w",
    )


def lora_init(params: dict, cfg: LoRAConfig, *, generator: torch.Generator,
              device) -> dict:
    """For each targeted leaf of ``params["layers"]``: A ~ 0.01 N(0, 1) of
    (in, r) and B = 0 of (r, out), so the initial model is the base; a
    stacked leaf (E, in, out) takes (E, in, r) and (E, r, out)."""
    tree: dict = {"layers": []}
    for layer in params["layers"]:
        entry = {}
        for name in cfg.targets:
            if name not in layer:
                continue
            *stack, n_in, n_out = layer[name].shape
            entry[name] = {
                "A": 0.01 * torch.randn((*stack, n_in, cfg.rank),
                                        generator=generator, device=device),
                "B": torch.zeros((*stack, cfg.rank, n_out), device=device),
            }
        tree["layers"].append(entry)
    return tree


def lora_apply(params: dict, lora: dict, cfg: LoRAConfig, *,
               train_base: bool = False, tp=None) -> dict:
    """Effective params: W + (alpha/rank) (A @ B) at the targeted leaves,
    the delta cast to W's dtype; every base leaf detached, not copied,
    unless ``train_base``. Under tensor parallelism (``tp``, the
    generator's ``TensorParallel``) a split leaf takes its rank's part of
    the delta: B's columns for a column-split W, A's rows for a row-split
    one (the adapters' gradients are then partial sums over the group). A
    stacked leaf's adapter goes unmerged into the layer's ``"adapters"``
    (``{name: (A, B, scale)}``), unless ``train_base`` (the export), which
    merges every expert."""
    scale = cfg.alpha / cfg.rank
    keep = (lambda v: v) if train_base else (lambda v: v.detach())
    merged = {k: keep(v) for k, v in params.items() if k != "layers"}
    merged["layers"] = []
    for layer, entry in zip(params["layers"], lora["layers"]):
        out = {k: keep(v) for k, v in layer.items()}
        for name, ab in entry.items():
            w = out[name]
            a, b = ab["A"], ab["B"]
            if w.dim() == 3 and not train_base:
                out.setdefault("adapters", {})[name] = (a, b, scale)
                continue
            if tp is not None and b.shape[1] != w.shape[1]:
                n = w.shape[1]
                b = b[:, tp.rank * n:(tp.rank + 1) * n]
            if tp is not None and a.shape[0] != w.shape[0]:
                n = w.shape[0]
                a = a[tp.rank * n:(tp.rank + 1) * n]
            out[name] = w + ((a @ b) * scale).to(w.dtype)
        merged["layers"].append(out)
    return merged


def lora_merge_export(params: dict, lora: dict, cfg: LoRAConfig) -> dict:
    """The adapters folded into the base for export (``lora.py:85-87``):
    ``lora_apply`` with ``train_base``."""
    return lora_apply(params, lora, cfg, train_base=True)


def gen_params(params: dict, lora_cfg: LoRAConfig | None, tp=None) -> dict:
    """The generator weights a forward uses: the LoRA-merged tree when an
    adapter is configured and present, else the base (``ApplyFns.gen_params``,
    ``train/modes.py:65-69``); ``tp`` as ``lora_apply`` takes it."""
    if lora_cfg is not None and "lora" in params:
        return lora_apply(params["generator"], params["lora"], lora_cfg,
                          tp=tp)
    return params["generator"]
