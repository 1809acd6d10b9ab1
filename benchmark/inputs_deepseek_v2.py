"""DeepSeek-V2's weights and LoRA adapters from a run's ``--seed``, in the
leaf tree the port's ``models/lm.py`` reads for ``arch="deepseek_v2"``:
``embed`` (V, H), ``lm_head`` (H, V), ``final_norm``, and per layer
``attn_norm``, ``q_w``, ``kv_a_w``, ``kv_norm``, ``kv_b_w``, ``o_w``,
``mlp_norm`` with the dense ``gate_w``/``up_w``/``down_w`` (the first
``first_k_dense_replace`` layers) or ``router_w`` (H, E), the routed
experts' stacks ``experts_{gate,up,down}_w`` (E, in, out) and the shared
experts' ``shared_{gate,up,down}_w``; matrices (in, out). The program and
the plain reference both read these, as ``inputs.py``'s other weights.

Every matrix and stack is N(0, ``initializer_range``) (the published init),
drawn in one call into one buffer on the device; norm scales are ones.
LoRA: A ~ 0.01 N(0, 1) (``models/lora.py::lora_init``'s A) and B ~ 0.01
N(0, 1), drawn non-zero so that every adapter takes a first gradient (the
program's init, B = 0, gives A none), over the recipe's peft targets as
they match DeepSeek-V2's modules: ``q_w``, ``o_w``, the dense MLP, the
shared experts and every routed expert (A (E, in, r), B (E, r, out)).
"""

from __future__ import annotations

import torch

from .inputs import _flat_normal

TARGETS = ("q_w", "o_w", "gate_w", "up_w", "down_w", "shared_gate_w",
           "shared_up_w", "shared_down_w", "experts_gate_w", "experts_up_w",
           "experts_down_w")


def layer_shapes(c: dict, i: int) -> list[tuple[str, tuple]]:
    """(leaf, shape) of layer ``i``'s matrices and stacks, in draw order."""
    h, nh = c["hidden_size"], c["num_attention_heads"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], \
        c["v_head_dim"]
    r = c["kv_lora_rank"]
    out = [("q_w", (h, nh * (dn + dr))), ("kv_a_w", (h, r + dr)),
           ("kv_b_w", (r, nh * (dn + dv))), ("o_w", (nh * dv, h))]
    if i < c["first_k_dense_replace"]:
        f = c["intermediate_size"]
        return out + [("gate_w", (h, f)), ("up_w", (h, f)),
                      ("down_w", (f, h))]
    e, f = c["n_routed_experts"], c["moe_intermediate_size"]
    fs = c["n_shared_experts"] * f
    return out + [("router_w", (h, e)), ("experts_gate_w", (e, h, f)),
                  ("experts_up_w", (e, h, f)), ("experts_down_w", (e, f, h)),
                  ("shared_gate_w", (h, fs)), ("shared_up_w", (h, fs)),
                  ("shared_down_w", (fs, h))]


def shapes(c: dict) -> list[tuple[str, tuple]]:
    out = [("embed", (c["vocab_size"], c["hidden_size"]))]
    for i in range(c["num_hidden_layers"]):
        out += [(f"layers.{i}.{n}", s) for n, s in layer_shapes(c, i)]
    out.append(("lm_head", (c["hidden_size"], c["vocab_size"])))
    return out


def n_params(c: dict) -> int:
    n = 0
    for _, s in shapes(c):
        k = 1
        for d in s:
            k *= d
        n += k
    return n


def lm_weights(c: dict, seed: int, device, dtype) -> dict:
    """The generator's weights: matrices N(0, initializer_range) in
    ``dtype``, norm scales ones."""
    spec = shapes(c)
    mats = dict(zip([p for p, _ in spec], _flat_normal(
        [s for _, s in spec], float(c["initializer_range"]), seed, device,
        dtype)))

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    layers = []
    for i in range(c["num_hidden_layers"]):
        layer = {n: mats[f"layers.{i}.{n}"] for n, _ in layer_shapes(c, i)}
        layer.update(attn_norm=ones(c["hidden_size"]),
                     kv_norm=ones(c["kv_lora_rank"]),
                     mlp_norm=ones(c["hidden_size"]))
        layers.append(layer)
    return {"embed": mats["embed"], "layers": layers,
            "final_norm": ones(c["hidden_size"]), "lm_head": mats["lm_head"]}


def lora_weights(c: dict, rank: int, seed: int, device) -> dict:
    """f32 adapters of every target of every layer, each leaf its own
    tensor: A (in, r) or (E, in, r), B (r, out) or (E, r, out), both 0.01
    N(0, 1)."""
    spec = [(i, n, s) for i in range(c["num_hidden_layers"])
            for n, s in layer_shapes(c, i) if n in TARGETS]
    ab = []
    for _, _, s in spec:
        *stack, n_in, n_out = s
        ab += [(*stack, n_in, rank), (*stack, rank, n_out)]
    drawn = _flat_normal(ab, 0.01, seed, device, torch.float32)
    layers = [{} for _ in range(c["num_hidden_layers"])]
    for j, (i, n, _) in enumerate(spec):
        layers[i][n] = {"A": drawn[2 * j].clone(), "B": drawn[2 * j + 1].clone()}
    return {"layers": layers}
