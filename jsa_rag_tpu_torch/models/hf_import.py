"""HF checkpoint directories -> the port's parameter trees.

Counterpart of ``jsa_rag_tpu/models/hf_import.py`` (:26-201). The config
functions take a parsed ``config.json`` (a dict) where the JAX package reads
a ``transformers`` config object, with the same fields and defaults
(``num_key_value_heads`` falls back to ``num_attention_heads``,
``rope_theta`` to 10000, ``rms_norm_eps`` to 1e-5, ``tie_word_embeddings``
to False; deepseek_v2's, which the JAX package does not read, follow
``DeepseekV2Config``). ``sliding_window`` is ignored in both packages:
Mistral's window is 4,096 tokens, and no path here reaches that length, so full causal
attention gives the same numbers. The ``import_*`` functions take a
state-dict mapping and return numpy trees under the JAX key names and
(in, out) layouts, every leaf float32 (``convert.py`` builds the port's
modules from them).

The directory reader needs neither ``transformers`` nor ``safetensors``:
``read_config`` parses ``config.json`` and ``read_state_dict`` returns a
lazy mapping over ``model.safetensors`` (the format: an 8-byte
little-endian header length, a JSON header of ``dtype``/``shape``/
``data_offsets`` relative to the end of the header, an optional
``__metadata__``, then the raw bytes; read through ``mmap`` and
``torch.frombuffer``, F32, F16 and BF16), the sharded
``model-0000i-of-0000n.safetensors`` with ``model.safetensors.index.json``
(its ``weight_map``), or ``pytorch_model.bin`` (and its sharded form) through
``torch.load(weights_only=True, mmap=True)``. Key prefixes that
``AutoModel`` strips are handled: ``bert.`` from a ``BertFor*`` save and
``transformer.`` from ``GPT2LMHeadModel``; a tied ``lm_head`` is absent
under ``tie_word_embeddings``; old ``embeddings.position_ids`` buffers are
never read.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from .bert import BertConfig
from .lm import DeepseekV2Config, LMConfig

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16}

# Pooling dispatch by model-name substring (``hf_import.py:187-201``,
# reference: src/retrievers.py:65-106).
POOLING_BY_MODEL = (
    ("bge", "cls_norm"),
    ("dpr", "cls"),
    ("contriever", "mean"),
    ("nomic", "mean_norm"),
    ("gte", "mean_norm"),
)


def pooling_for_model_name(name: str) -> str:
    low = name.lower()
    for key, pooling in POOLING_BY_MODEL:
        if key in low:
            return pooling
    return "mean"


# ------------------------------------------------------------------ reading
def read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


class _SafetensorsFile:
    """One ``.safetensors`` file, memory-mapped; ``get(name)`` -> a tensor
    that views the map (copy-on-write, so no read-only buffer warning)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: no safetensors header")
            (n,) = struct.unpack("<Q", head)
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.path = path
        self.base = 8 + n
        header.pop("__metadata__", None)
        self.entries = header
        for name, e in header.items():
            lo, hi = e["data_offsets"]
            if not 0 <= lo <= hi <= len(self._map) - self.base:
                raise ValueError(f"{path}: tensor {name!r} lies past the "
                                 f"end of the file")

    def get(self, name: str) -> torch.Tensor:
        e = self.entries[name]
        dtype = SAFETENSORS_DTYPES.get(e["dtype"])
        if dtype is None:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{e['dtype']}; F32, F16 and BF16 are read")
        lo, hi = e["data_offsets"]
        count = int(np.prod(e["shape"], dtype=np.int64))
        if hi - lo != count * dtype.itemsize:
            raise ValueError(f"{self.path}: tensor {name!r} holds "
                             f"{hi - lo} bytes for shape {e['shape']}")
        if count == 0:
            return torch.empty(e["shape"], dtype=dtype)
        t = torch.frombuffer(self._map, dtype=dtype, count=count,
                             offset=self.base + lo)
        return t.reshape(e["shape"])


class StateDict(Mapping):
    """Lazy ``{name: tensor}`` over an HF checkpoint directory: a tensor is
    read when it is looked up."""

    def __init__(self, sources: dict[str, Any]):
        self._sources = sources  # name -> a _SafetensorsFile or a dict

    def __getitem__(self, name: str) -> torch.Tensor:
        src = self._sources[name]
        if isinstance(src, _SafetensorsFile):
            return src.get(name)
        return src[name]

    def __iter__(self):
        return iter(self._sources)

    def __len__(self) -> int:
        return len(self._sources)


def read_state_dict(path: str) -> StateDict:
    """The weights of the HF directory ``path``: ``model.safetensors``,
    its sharded form, ``pytorch_model.bin`` or its sharded form, in that
    order of preference."""
    def files(index_name, single):
        index = os.path.join(path, index_name)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            return weight_map, sorted(set(weight_map.values()))
        if os.path.exists(os.path.join(path, single)):
            return None, [single]
        return None, []

    weight_map, names = files("model.safetensors.index.json",
                              "model.safetensors")
    loader = _SafetensorsFile
    if not names:
        weight_map, names = files("pytorch_model.bin.index.json",
                                  "pytorch_model.bin")
        loader = _load_bin
    if not names:
        raise FileNotFoundError(
            f"{path} holds no model.safetensors, sharded safetensors or "
            "pytorch_model.bin")
    opened = {n: loader(os.path.join(path, n)) for n in names}
    if weight_map is None:
        (src,) = opened.values()
        keys = src.entries if isinstance(src, _SafetensorsFile) else src
        return StateDict({k: src for k in keys})
    sources = {}
    for key, fname in weight_map.items():
        src = opened[fname]
        held = src.entries if isinstance(src, _SafetensorsFile) else src
        if key not in held:
            raise ValueError(f"{path}: {fname} lacks {key!r}, which the "
                             "index maps to it")
        sources[key] = src
    return StateDict(sources)


def _load_bin(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


# --------------------------------------------------------------- importing
def _np(t) -> np.ndarray:
    """A leaf as float32 numpy (the JAX package's ``_np`` of an f32
    model)."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _np_t(t) -> np.ndarray:
    """A torch ``Linear`` weight (out, in) as a contiguous (in, out)
    float32 array."""
    return np.ascontiguousarray(_np(t).T)


def _strip(state_dict: Mapping, prefix: str) -> Mapping:
    """Keys with ``prefix`` removed where the save added it (a ``BertFor*``
    or ``GPT2LMHeadModel`` save); lookups stay lazy."""
    if not any(k.startswith(prefix) for k in state_dict):
        return state_dict
    return _Renamed(state_dict, prefix)


class _Renamed(Mapping):
    def __init__(self, inner: Mapping, prefix: str):
        self._inner, self._prefix = inner, prefix

    def __getitem__(self, name):
        return self._inner[self._prefix + name]

    def __iter__(self):
        n = len(self._prefix)
        return (k[n:] for k in self._inner if k.startswith(self._prefix))

    def __len__(self):
        return sum(1 for _ in self)


def bert_config_from_hf(cfg: dict, pooling: str = "mean") -> BertConfig:
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        intermediate=cfg["intermediate_size"],
        max_positions=cfg["max_position_embeddings"],
        type_vocab=cfg["type_vocab_size"],
        ln_eps=cfg["layer_norm_eps"],
        pooling=pooling,
    )


def import_bert(state_dict: Mapping, n_layers: int) -> dict:
    """An HF ``BertModel`` state dict -> the BERT tower tree; every linear
    weight transposed to (in, out)."""
    sd = _strip(state_dict, "bert.")

    def lin(name):
        return _np_t(sd[f"{name}.weight"]), _np(sd[f"{name}.bias"])

    p = {
        "embed": {
            "word": _np(sd["embeddings.word_embeddings.weight"]),
            "position": _np(sd["embeddings.position_embeddings.weight"]),
            "type": _np(sd["embeddings.token_type_embeddings.weight"]),
            "ln_scale": _np(sd["embeddings.LayerNorm.weight"]),
            "ln_bias": _np(sd["embeddings.LayerNorm.bias"]),
        },
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"encoder.layer.{i}."
        qw, qb = lin(pre + "attention.self.query")
        kw, kb = lin(pre + "attention.self.key")
        vw, vb = lin(pre + "attention.self.value")
        ow, ob = lin(pre + "attention.output.dense")
        iw, ib = lin(pre + "intermediate.dense")
        fw, fb = lin(pre + "output.dense")
        p["layers"].append({
            "q_w": qw, "q_b": qb, "k_w": kw, "k_b": kb,
            "v_w": vw, "v_b": vb, "o_w": ow, "o_b": ob,
            "attn_ln_scale": _np(sd[pre + "attention.output.LayerNorm.weight"]),
            "attn_ln_bias": _np(sd[pre + "attention.output.LayerNorm.bias"]),
            "ffn_in_w": iw, "ffn_in_b": ib,
            "ffn_out_w": fw, "ffn_out_b": fb,
            "ffn_ln_scale": _np(sd[pre + "output.LayerNorm.weight"]),
            "ffn_ln_bias": _np(sd[pre + "output.LayerNorm.bias"]),
        })
    return p


def lm_config_from_hf(cfg: dict, dtype=None) -> LMConfig:
    heads = cfg["num_attention_heads"]
    return LMConfig(
        vocab_size=cfg["vocab_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=heads,
        kv_heads=cfg.get("num_key_value_heads") or heads,
        intermediate=cfg["intermediate_size"],
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-5),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        dtype=dtype if dtype is not None else torch.bfloat16,
    )


def import_causal_lm(state_dict: Mapping, n_layers: int,
                     tie_embeddings: bool = False) -> dict:
    """An HF Llama/Mistral ``*ForCausalLM`` state dict -> the generator
    tree (reference: src/model_io.py:110-131)."""
    sd = state_dict

    def w(name):  # torch Linear weight (out, in) -> x @ W wants (in, out)
        return _np_t(sd[name])

    p = {
        "embed": _np(sd["model.embed_tokens.weight"]),
        "final_norm": _np(sd["model.norm.weight"]),
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"model.layers.{i}."
        p["layers"].append({
            "attn_norm": _np(sd[pre + "input_layernorm.weight"]),
            "q_w": w(pre + "self_attn.q_proj.weight"),
            "k_w": w(pre + "self_attn.k_proj.weight"),
            "v_w": w(pre + "self_attn.v_proj.weight"),
            "o_w": w(pre + "self_attn.o_proj.weight"),
            "mlp_norm": _np(sd[pre + "post_attention_layernorm.weight"]),
            "gate_w": w(pre + "mlp.gate_proj.weight"),
            "up_w": w(pre + "mlp.up_proj.weight"),
            "down_w": w(pre + "mlp.down_proj.weight"),
        })
    if not tie_embeddings:
        p["lm_head"] = w("lm_head.weight")
    return p


def gpt2_config_from_hf(cfg: dict, dtype=None) -> LMConfig:
    return LMConfig(
        arch="gpt2",
        vocab_size=cfg["vocab_size"],
        hidden=cfg["n_embd"],
        layers=cfg["n_layer"],
        heads=cfg["n_head"],
        kv_heads=cfg["n_head"],
        intermediate=4 * cfg["n_embd"],
        max_positions=cfg["n_positions"],
        tie_embeddings=True,
        dtype=dtype if dtype is not None else torch.bfloat16,
    )


def import_gpt2(state_dict: Mapping, n_layers: int) -> dict:
    """An HF ``GPT2LMHeadModel`` state dict (reference:
    src/model_io.py:123-127). GPT2's Conv1D weights are already (in, out):
    no transpose."""
    sd = _strip(state_dict, "transformer.")
    p = {
        "embed": _np(sd["wte.weight"]),
        "pos_embed": _np(sd["wpe.weight"]),
        "final_norm": _np(sd["ln_f.weight"]),
        "final_norm_b": _np(sd["ln_f.bias"]),
        "layers": [],
    }
    for i in range(n_layers):
        pre = f"h.{i}."
        p["layers"].append({
            "ln1_s": _np(sd[pre + "ln_1.weight"]),
            "ln1_b": _np(sd[pre + "ln_1.bias"]),
            "qkv_w": _np(sd[pre + "attn.c_attn.weight"]),
            "qkv_b": _np(sd[pre + "attn.c_attn.bias"]),
            "o_w": _np(sd[pre + "attn.c_proj.weight"]),
            "o_b": _np(sd[pre + "attn.c_proj.bias"]),
            "ln2_s": _np(sd[pre + "ln_2.weight"]),
            "ln2_b": _np(sd[pre + "ln_2.bias"]),
            "fc_w": _np(sd[pre + "mlp.c_fc.weight"]),
            "fc_b": _np(sd[pre + "mlp.c_fc.bias"]),
            "proj_w": _np(sd[pre + "mlp.c_proj.weight"]),
            "proj_b": _np(sd[pre + "mlp.c_proj.bias"]),
        })
    return p


def deepseek_config_from_hf(cfg: dict, dtype=None) -> DeepseekV2Config:
    """A ``deepseek_v2`` ``config.json`` -> the deepseek_v2 ``LMConfig``
    (``DeepseekV2Config``'s defaults where a key is absent). What the port
    does not compute raises: a query latent (``q_lora_rank``), routing
    other than the greedy top-k of a softmax with its probabilities as the
    weights (``norm_topk_prob`` false, ``routed_scaling_factor`` 1), MoE
    layers other than every layer after the dense ones, no shared experts,
    rope scaling other than YaRN. DeepSeek-V2-Lite is all of these."""
    if cfg.get("q_lora_rank"):
        raise ValueError("a query latent (q_lora_rank) is not supported")
    if (cfg.get("topk_method", "greedy") != "greedy"
            or cfg.get("scoring_func", "softmax") != "softmax"
            or cfg.get("norm_topk_prob", False)
            or float(cfg.get("routed_scaling_factor", 1.0)) != 1.0
            or cfg.get("moe_layer_freq", 1) != 1
            or not cfg.get("n_shared_experts")):
        raise ValueError("only greedy softmax routing with unscaled, "
                         "unrenormalised weights, in every layer after the "
                         "dense ones and beside shared experts, is supported")
    rs = cfg.get("rope_scaling") or {}
    if rs.get("type", rs.get("rope_type")) != "yarn":
        raise ValueError(f"rope scaling {rs!r}: only yarn is supported")
    yarn = (float(rs["factor"]), int(rs["original_max_position_embeddings"]),
            float(rs.get("beta_fast", 32)), float(rs.get("beta_slow", 1)),
            float(rs.get("mscale", 1)), float(rs.get("mscale_all_dim", 0)))
    heads = cfg["num_attention_heads"]
    return DeepseekV2Config(
        vocab_size=cfg["vocab_size"],
        hidden=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"],
        heads=heads,
        kv_heads=heads,
        intermediate=cfg["intermediate_size"],
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        dtype=dtype if dtype is not None else torch.bfloat16,
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        n_experts=cfg["n_routed_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        expert_intermediate=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        first_dense_layers=cfg.get("first_k_dense_replace", 0),
        yarn=yarn,
    )


def import_deepseek_v2(state_dict: Mapping, cfg: LMConfig) -> dict:
    """An HF ``DeepseekV2ForCausalLM`` state dict -> the deepseek_v2 tree:
    every linear weight (out, in) -> (in, out); each MoE layer's
    ``mlp.experts.<e>.*_proj`` stacked into (E, in, out), its
    ``mlp.gate.weight`` (E, H) -> ``router_w`` (H, E), its shared experts'
    SwiGLU as ``shared_*``; the dense layers' ``mlp.*_proj`` as llama's.
    The rope columns stay in HF's order (``lm.py::_mla_rope`` rotates the
    interleaved pairs)."""
    sd = state_dict

    def w(name):
        return _np_t(sd[name])

    p = {"embed": _np(sd["model.embed_tokens.weight"]),
         "final_norm": _np(sd["model.norm.weight"]), "layers": []}
    for i in range(cfg.layers):
        pre = f"model.layers.{i}."
        att, mlp = pre + "self_attn.", pre + "mlp."
        layer = {
            "attn_norm": _np(sd[pre + "input_layernorm.weight"]),
            "q_w": w(att + "q_proj.weight"),
            "kv_a_w": w(att + "kv_a_proj_with_mqa.weight"),
            "kv_norm": _np(sd[att + "kv_a_layernorm.weight"]),
            "kv_b_w": w(att + "kv_b_proj.weight"),
            "o_w": w(att + "o_proj.weight"),
            "mlp_norm": _np(sd[pre + "post_attention_layernorm.weight"]),
        }
        for part in ("gate", "up", "down"):
            if i < cfg.first_dense_layers:
                layer[f"{part}_w"] = w(f"{mlp}{part}_proj.weight")
                continue
            layer[f"experts_{part}_w"] = np.stack(
                [w(f"{mlp}experts.{e}.{part}_proj.weight")
                 for e in range(cfg.n_experts)])
            layer[f"shared_{part}_w"] = w(
                f"{mlp}shared_experts.{part}_proj.weight")
        if i >= cfg.first_dense_layers:
            layer["router_w"] = w(mlp + "gate.weight")
        p["layers"].append(layer)
    if not cfg.tie_embeddings:
        p["lm_head"] = w("lm_head.weight")
    return p


# ------------------------------------------------------------- directories
def load_hf_retriever(path: str, pooling: str):
    """-> (BertConfig, tower tree) from the HF directory ``path``."""
    cfg = bert_config_from_hf(read_config(path), pooling=pooling)
    return cfg, import_bert(read_state_dict(path), cfg.layers)


def hf_generator_config(path: str) -> LMConfig:
    """The generator's config from ``path``'s ``config.json`` (gpt2,
    deepseek_v2 or the llama family, by ``model_type``)."""
    cfg = read_config(path)
    if cfg.get("model_type") == "gpt2":
        return gpt2_config_from_hf(cfg)
    if cfg.get("model_type") == "deepseek_v2":
        return deepseek_config_from_hf(cfg)
    return lm_config_from_hf(cfg)


def load_hf_generator(path: str):
    """-> (LMConfig, generator tree) from the HF directory ``path``."""
    cfg = hf_generator_config(path)
    sd = read_state_dict(path)
    if cfg.arch == "gpt2":
        return cfg, import_gpt2(sd, cfg.layers)
    if cfg.arch == "deepseek_v2":
        return cfg, import_deepseek_v2(sd, cfg)
    return cfg, import_causal_lm(sd, cfg.layers, cfg.tie_embeddings)
