"""Write HF checkpoint directories without ``transformers`` or
``safetensors``: the writer counterpart of ``models/hf_import.py``'s reader.

``write_safetensors`` writes one ``.safetensors`` file in the format the
reader parses. ``bert_state_dict`` and ``gpt2_state_dict`` lay out a
``BertModel`` and a ``GPT2LMHeadModel`` state dict under HF's key names and
layouts (``nn.Linear``'s (out, in) for BERT, ``Conv1D``'s (in, out) for
gpt2, gpt2's head tied and absent) from an ``init`` of three functions
``(w(*shape), ones(n), zeros(n))``; ``deepseek_v2_state_dict`` a
``DeepseekV2ForCausalLM``'s (each routed expert its own ``nn.Linear``s); ``hf_init`` makes one from a
``torch.Generator`` at HF's ``initializer_range`` 0.02. ``write_hf_dir``
writes ``config.json``.
"""

from __future__ import annotations

import json
import os

import torch

SAFETENSORS_NAMES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}


def write_safetensors(path: str, tensors: dict, metadata=None) -> None:
    """``{name: CPU tensor}`` -> one ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header (``dtype``, ``shape``,
    ``data_offsets`` from the end of the header; ``__metadata__``) padded
    with spaces to 8 bytes, then each tensor's bytes in order."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_NAMES[str(t.dtype).removeprefix(
            "torch.")], "shape": list(t.shape),
            "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                    .data)


def write_hf_dir(path: str, config: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)


def hf_init(g: torch.Generator, dtype=torch.float32, device="cpu"):
    """-> (w(*shape), ones(n), zeros(n)): normal(0, 0.02) weights drawn on
    ``device`` from ``g`` and returned on the host, unit norm scales, zero
    biases."""
    def w(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            0.0, 0.02, generator=g).cpu()

    def ones(n):
        return torch.ones((n,), dtype=dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype)

    return w, ones, zeros


def bert_state_dict(c: dict, init) -> dict:
    """A ``BertModel`` state dict of config ``c`` (HF's field names), the
    pooler included (the import ignores it)."""
    w, ones, zeros = init
    h, f = c["hidden_size"], c["intermediate_size"]
    sd = {"embeddings.word_embeddings.weight": w(c["vocab_size"], h),
          "embeddings.position_embeddings.weight": w(
              c["max_position_embeddings"], h),
          "embeddings.token_type_embeddings.weight": w(
              c.get("type_vocab_size", 2), h),
          "embeddings.LayerNorm.weight": ones(h),
          "embeddings.LayerNorm.bias": zeros(h)}
    for i in range(c["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."
        for name, (n_out, n_in) in (
                ("attention.self.query", (h, h)),
                ("attention.self.key", (h, h)),
                ("attention.self.value", (h, h)),
                ("attention.output.dense", (h, h)),
                ("intermediate.dense", (f, h)),
                ("output.dense", (h, f))):
            sd[pre + name + ".weight"] = w(n_out, n_in)
            sd[pre + name + ".bias"] = zeros(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"] = ones(h)
            sd[pre + name + ".bias"] = zeros(h)
    sd["pooler.dense.weight"] = w(h, h)
    sd["pooler.dense.bias"] = zeros(h)
    return sd


def gpt2_state_dict(c: dict, init) -> dict:
    """A ``GPT2LMHeadModel`` state dict of config ``c``: Conv1D (in, out)
    layouts, the head tied (absent)."""
    w, ones, zeros = init
    h, v = c["n_embd"], c["vocab_size"]
    sd = {"transformer.wte.weight": w(v, h),
          "transformer.wpe.weight": w(c["n_positions"], h)}
    for i in range(c["n_layer"]):
        pre = f"transformer.h.{i}."
        sd.update({
            pre + "ln_1.weight": ones(h), pre + "ln_1.bias": zeros(h),
            pre + "attn.c_attn.weight": w(h, 3 * h),
            pre + "attn.c_attn.bias": zeros(3 * h),
            pre + "attn.c_proj.weight": w(h, h),
            pre + "attn.c_proj.bias": zeros(h),
            pre + "ln_2.weight": ones(h), pre + "ln_2.bias": zeros(h),
            pre + "mlp.c_fc.weight": w(h, 4 * h),
            pre + "mlp.c_fc.bias": zeros(4 * h),
            pre + "mlp.c_proj.weight": w(4 * h, h),
            pre + "mlp.c_proj.bias": zeros(h)})
    sd["transformer.ln_f.weight"] = ones(h)
    sd["transformer.ln_f.bias"] = zeros(h)
    return sd


def deepseek_v2_state_dict(c: dict, init) -> dict:
    """A ``DeepseekV2ForCausalLM`` state dict of config ``c`` (HF's field
    names, no query latent): ``nn.Linear``'s (out, in) layouts, the dense
    MLP in the first ``first_k_dense_replace`` layers, then the router
    (``mlp.gate``), every routed expert and the shared experts."""
    w, ones, _ = init
    h, v, nh = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"])
    r, e, f = c["kv_lora_rank"], c["n_routed_experts"], \
        c["moe_intermediate_size"]
    sd = {"model.embed_tokens.weight": w(v, h)}
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        att, mlp = pre + "self_attn.", pre + "mlp."
        sd.update({
            pre + "input_layernorm.weight": ones(h),
            att + "q_proj.weight": w(nh * (dn + dr), h),
            att + "kv_a_proj_with_mqa.weight": w(r + dr, h),
            att + "kv_a_layernorm.weight": ones(r),
            att + "kv_b_proj.weight": w(nh * (dn + dv), r),
            att + "o_proj.weight": w(h, nh * dv),
            pre + "post_attention_layernorm.weight": ones(h)})
        if i < c.get("first_k_dense_replace", 0):
            mlps = {mlp: c["intermediate_size"]}
        else:
            sd[mlp + "gate.weight"] = w(e, h)
            mlps = {f"{mlp}experts.{j}.": f for j in range(e)}
            mlps[mlp + "shared_experts."] = c["n_shared_experts"] * f
        for p, width in mlps.items():
            sd.update({p + "gate_proj.weight": w(width, h),
                       p + "up_proj.weight": w(width, h),
                       p + "down_proj.weight": w(h, width)})
    sd["model.norm.weight"] = ones(h)
    sd["lm_head.weight"] = w(v, h)
    return sd
