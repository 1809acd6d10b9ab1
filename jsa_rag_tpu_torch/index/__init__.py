"""Index construction and loading (counterpart of
``jsa_rag_tpu/index/__init__.py``): flat int8r only in this slice."""

from __future__ import annotations

import json
import os

from .flat import ShardedFlatIndex


def build_index_for(opt, n_passages: int, dim: int, device="cuda"):
    """Construct the index an options object asks for (``index_mode``,
    ``faiss_index_type``, ``index_dtype``, ``int8r_refine``, ``refine_r``
    — the JAX package's flag names). IVF and PQ modes are ROADMAP queue A
    item 14."""
    mode = opt.index_mode
    if mode == "faiss" and opt.faiss_index_type == "flat":
        mode = "flat"
    if mode != "flat":
        raise NotImplementedError(
            f"index_mode {opt.index_mode!r} is not ported yet: IVF/PQ "
            "indexes are ROADMAP queue A item 14")
    idx = ShardedFlatIndex(n_passages, dim, dtype=opt.index_dtype,
                           device=device, int8r_refine=opt.int8r_refine)
    idx.refine_r = opt.refine_r
    return idx


def load_index(path: str, device="cuda", expected_dim: int | None = None,
               refine_r: int | None = None, int8r_refine: str = "rows"):
    """Load a saved index. ``expected_dim`` validates against the live
    retriever's hidden size; ``refine_r`` overrides the rescore-pool width
    so a loaded index searches with the same pool as a freshly built one."""
    with open(os.path.join(path, "meta.json")) as f:
        kind = json.load(f).get("kind", "flat")
    if kind != "flat":
        raise NotImplementedError(
            f"{kind} index at {path}: IVF is ROADMAP queue A item 14")
    index = ShardedFlatIndex.load(path, device=device,
                                  int8r_refine=int8r_refine)
    if refine_r is not None:
        index.refine_r = refine_r
    if expected_dim is not None and index.dim != expected_dim:
        raise ValueError(
            f"loaded index dim {index.dim} != retriever hidden "
            f"{expected_dim} — the index at {path} was built with a "
            f"different encoder")
    return index
