"""Carry weights between the JAX package's pytrees and the port.

Retriever. The JAX retriever's parameters are ``{"query": tower, "passage": tower}``
(untied) or ``{"shared": tower}`` (tied), each tower
``{"embed": {name: array}, "layers": [{name: array}, ...]}`` with (in, out)
weight layout. The port's ``DualEncoderRetriever`` state dict uses the same
names as dotted paths (``query.embed.word``, ``passage.layers.3.q_w``), so
conversion is a rename, never a transpose. Arrays travel as numpy.

Generator and LoRA. The port's LM (``models/lm.py``) takes the JAX tree's
structure as it is — ``{"embed", "final_norm", "lm_head", "layers": [...]}``
and ``{"layers": [{name: {"A", "B"}}]}`` — with torch leaves, so conversion
maps leaves and keeps the key names and (in, out) layouts.

Whole trees. ``params_to_numpy`` / ``params_from_numpy`` carry the training
tree — ``retriever``, ``post_retriever`` (all its towers, or the query tower
alone under ``decouple_encoder``), ``generator`` and ``lora`` — under the same
top-level keys, as a checkpoint pickle holds it.

Demo artifacts. ``load_demo_artifacts`` reads the hard-copy encoder and
generator pickles (numpy fp16 leaves + a SimpleTokenizer vocab) through
``demo/``'s loaders, the counterparts of
``scripts/pretrain_hard_encoder.py:37-53`` and
``scripts/pretrain_copy_generator.py:30-43``, which import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

TOWERS = ("shared", "query", "passage")


def retriever_params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """JAX retriever pytree (numpy or array-like leaves) -> the port's
    ``DualEncoderRetriever`` state dict, in f32."""
    unknown = set(tree) - set(TOWERS)
    if unknown or not tree:
        raise ValueError(f"retriever tree keys must be among {TOWERS}, got "
                         f"{sorted(tree)}")
    state = {}
    for tower, p in tree.items():
        for name, v in p["embed"].items():
            state[f"{tower}.embed.{name}"] = _tensor(v)
        for i, layer in enumerate(p["layers"]):
            for name, v in layer.items():
                state[f"{tower}.layers.{i}.{name}"] = _tensor(v)
    return state


def retriever_params_to_numpy(state) -> dict:
    """The port's state dict (or the module) -> JAX retriever pytree of f32
    numpy arrays."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    tree: dict = {}
    for key, v in state.items():
        parts = key.split(".")
        tower, group = parts[0], parts[1]
        t = tree.setdefault(tower, {"embed": {}, "layers": []})
        arr = v.detach().to(torch.float32).cpu().numpy()
        if group == "embed":
            t["embed"][parts[2]] = arr
        elif group == "layers":
            i = int(parts[2])
            while len(t["layers"]) <= i:
                t["layers"].append({})
            t["layers"][i][parts[3]] = arr
        else:
            raise ValueError(f"unexpected retriever state key {key!r}")
    return tree


def _tensor(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def numpy_float16(tree):
    """A numpy pytree with every leaf as float16: how the demo artifacts
    store their params."""
    return _map_tree(tree, lambda v: np.asarray(v, np.float16))


def lm_params_from_numpy(tree: dict, device="cpu",
                         dtype=torch.float32) -> dict:
    """JAX generator pytree (llama or gpt2; numpy or array-like leaves) ->
    the port's parameter dict of ``dtype`` tensors on ``device``."""
    return _map_tree(tree, lambda v: _tensor(v).to(device, dtype))


def lm_params_to_numpy(params: dict) -> dict:
    """The port's generator (or LoRA) dict -> a JAX pytree of f32 numpy
    arrays."""
    return _map_tree(
        params, lambda v: v.detach().to(torch.float32).cpu().numpy())


def lora_params_from_numpy(tree: dict, device="cpu") -> dict:
    """JAX LoRA tree ``{"layers": [{name: {"A", "B"}}]}`` -> the port's, f32
    tensors on ``device``."""
    if set(tree) != {"layers"}:
        raise ValueError(f"LoRA tree keys must be ['layers'], got "
                         f"{sorted(tree)}")
    return _map_tree(tree, lambda v: _tensor(v).to(device))


def retriever_from_numpy(tree: dict, cfg, device="cpu"):
    """A JAX retriever pytree -> a ``DualEncoderRetriever`` on ``device``
    holding exactly the towers the tree has (a decoupled posterior has its
    query tower only)."""
    from .models.bert import BertEncoder
    from .models.retriever import DualEncoderRetriever

    module = DualEncoderRetriever(
        cfg, towers={name: BertEncoder(cfg.bert, device=device)
                     for name in tree})
    module.load_state_dict(retriever_params_from_numpy(tree))
    return module


RETRIEVERS = ("retriever", "post_retriever")


def params_to_numpy(params: dict) -> dict:
    """The port's params dict -> the JAX package's param pytree of f32 numpy
    arrays, key for key."""
    return {key: (retriever_params_to_numpy(sub) if key in RETRIEVERS
                  else lm_params_to_numpy(sub))
            for key, sub in params.items()}


def params_from_numpy(tree: dict, retriever_cfg, device="cpu") -> dict:
    """The JAX package's param pytree -> the port's params dict on
    ``device``: retrievers as modules of ``retriever_cfg``'s geometry, the
    generator and LoRA as tensor dicts."""
    out = {}
    for key, sub in tree.items():
        if key in RETRIEVERS:
            out[key] = retriever_from_numpy(sub, retriever_cfg, device)
        elif key == "lora":
            out[key] = lora_params_from_numpy(sub, device)
        elif key == "generator":
            out[key] = lm_params_from_numpy(sub, device)
        else:
            raise ValueError(f"unexpected param tree key {key!r}")
    return out


def load_demo_artifacts(encoder_path: str, generator_path: str,
                        device="cpu"):
    """The hard-copy demo pickles -> (retriever, generator config,
    generator params, tokenizer): a tied ``DualEncoderRetriever`` in f32 on
    ``device``, the ``LMConfig`` at f32, its f32 params, and the shared
    ``SimpleTokenizer`` restored from the generator's vocab (both pickles
    carry the same one). The loaders are ``demo/``'s."""
    from .demo.pretrain_copy_generator import load_generator
    from .demo.pretrain_hard_encoder import load_artifact

    retriever, _ = load_artifact(encoder_path, device)
    return (retriever, *load_generator(generator_path, device))
