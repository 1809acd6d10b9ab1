"""Carry retriever weights between the JAX package's pytree and the port.

The JAX retriever's parameters are ``{"query": tower, "passage": tower}``
(untied) or ``{"shared": tower}`` (tied), each tower
``{"embed": {name: array}, "layers": [{name: array}, ...]}`` with (in, out)
weight layout. The port's ``DualEncoderRetriever`` state dict uses the same
names as dotted paths (``query.embed.word``, ``passage.layers.3.q_w``), so
conversion is a rename, never a transpose. Arrays travel as numpy.
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
