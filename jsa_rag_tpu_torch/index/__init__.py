"""Index construction and loading (counterpart of
``jsa_rag_tpu/index/__init__.py``): the flat index in every storage and the
IVF index (dense, sq8, pq; the reference's FAISS ivfflat / ivfsq / ivfpq /
pq modes). The flat index shards over the processes of the grid; the
sharded IVF index is ROADMAP queue A item 13b."""

from __future__ import annotations

import json
import os

from ..parallel.mesh import process_count
from .flat import ShardedFlatIndex
from .ivf import ShardedIVFIndex

FAISS_STORAGE = {"ivfflat": "dense", "ivfsq": "sq8", "ivfpq": "pq",
                 "pq": "pq"}


def check_refine_gather(refine_gather: str) -> None:
    """The JAX package's check (``index/__init__.py:69-72``,
    ``index/flat.py:200-203``). The two accepted values have no effect
    here: the port's store is already row-major."""
    if refine_gather not in ("cols", "rows"):
        raise ValueError(
            f"refine_gather must be 'cols' or 'rows', got "
            f"{refine_gather!r}")


def _one_shard_ivf(grid) -> None:
    if (grid.world if grid is not None else process_count()) > 1:
        raise NotImplementedError(
            "the IVF index over several processes (its assignment allgather "
            "and merge) is ROADMAP queue A item 13b; use the flat index")


def build_index_for(opt, n_passages: int, dim: int, device="cuda",
                    grid=None):
    """Construct the index an options object asks for (``index_mode``,
    ``faiss_index_type``, ``faiss_code_size``, ``ivf_n_lists``,
    ``ivf_n_probe``, ``ivf_refine``, ``index_dtype``, ``int8r_refine``,
    ``refine_r`` — the JAX package's flag names). ``--index_mode faiss``
    follows the reference's flags: flat -> the flat index; ivfflat -> IVF
    dense; ivfsq -> IVF sq8; ivfpq -> IVF pq of ``faiss_code_size`` bytes a
    row; pq -> pq with one list, fully probed. ``refine_gather`` is checked
    as the JAX package checks it and has no other effect. Any other mode is
    flat, as in the JAX package. The flat index shards over ``grid`` (the
    processes' grid; None: every process)."""
    mode, storage = opt.index_mode, "dense"
    ftype = opt.faiss_index_type if mode == "faiss" else None
    if ftype not in (None, "flat"):
        if ftype not in FAISS_STORAGE:
            raise ValueError(f"unknown faiss_index_type {ftype!r}")
        mode, storage = "ivf", FAISS_STORAGE[ftype]
    if mode == "ivf":
        _one_shard_ivf(grid)
        n_lists, n_probe = opt.ivf_n_lists or None, opt.ivf_n_probe or None
        if ftype == "pq":  # flat PQ: one list, scanned whole
            n_lists = n_probe = 1
        idx = ShardedIVFIndex(n_passages, dim, opt.index_dtype,
                              device=device, n_lists=n_lists,
                              n_probe=n_probe, storage=storage,
                              code_size=opt.faiss_code_size,
                              refine=opt.ivf_refine)
    else:
        check_refine_gather(opt.refine_gather)
        idx = ShardedFlatIndex(n_passages, dim, dtype=opt.index_dtype,
                               device=device, int8r_refine=opt.int8r_refine,
                               grid=grid)
    idx.refine_r = opt.refine_r
    return idx


def load_index(path: str, device="cuda", method: str = "auto",
               expected_dim: int | None = None, refine_r: int | None = None,
               int8r_refine: str = "rows", refine_gather: str = "cols",
               grid=None):
    """Load a saved index, dispatching on its meta ``kind`` (flat / ivf).
    ``expected_dim`` validates against the live retriever's hidden size;
    ``refine_r`` overrides the rescore-pool width so a loaded index searches
    with the same pool as a freshly built one; ``refine_gather`` is checked
    for a flat index as the JAX package checks it. A flat index loads
    sharded over ``grid`` (None: every process)."""
    with open(os.path.join(path, "meta.json")) as f:
        kind = json.load(f).get("kind", "flat")
    if kind == "ivf":
        _one_shard_ivf(grid)
        index = ShardedIVFIndex.load(path, device=device)
    elif kind == "flat":
        check_refine_gather(refine_gather)
        index = ShardedFlatIndex.load(path, device=device, method=method,
                                      int8r_refine=int8r_refine, grid=grid)
    else:
        raise ValueError(f"unknown index kind {kind!r} at {path}")
    if refine_r is not None:
        index.refine_r = refine_r
    if expected_dim is not None and index.dim != expected_dim:
        raise ValueError(
            f"loaded index dim {index.dim} != retriever hidden "
            f"{expected_dim} — the index at {path} was built with a "
            f"different encoder")
    return index
