"""Checkpoint loading (counterpart of the load half of
``jsa_rag_tpu/train/checkpoint.py``, :172-197), so a ``--model_path``
written by the JAX trainer evaluates in the port.

A checkpoint is ``<run>/step-N/state.pkl`` (``{"step", "params",
"opt_state"?}``, numpy leaves) beside ``tokenizer.json`` /
``retriever_tokenizer.json``, with a ``latest`` symlink in the run dir.
Leaves stored in float32 or float16 load; a tree saved under
``--param_dtype bfloat16`` holds ml_dtypes bf16 arrays, which need the
ml_dtypes package to unpickle and which the port does not carry — loading
one raises. ``save_checkpoint`` comes with the training slice (ROADMAP
queue A item 9). Only load checkpoints this project wrote: unpickling runs
code.
"""

from __future__ import annotations

import json
import os
import pickle

from ..data.tokenizer import SimpleTokenizer


def _resolve(path: str) -> str:
    latest = os.path.join(path, "latest")
    if os.path.isdir(latest) or os.path.islink(latest):
        return latest
    return path


def load_tokenizers_from_checkpoint(path: str):
    """Restore SimpleTokenizer vocabs saved next to a checkpoint. Returns
    (generator_tok | None, retriever_tok | None)."""
    path = _resolve(path)
    out = []
    for fname in ("tokenizer.json", "retriever_tokenizer.json"):
        p = os.path.join(path, fname)
        if os.path.exists(p):
            with open(p) as f:
                out.append(SimpleTokenizer.from_dict(json.load(f)))
        else:
            out.append(None)
    return tuple(out)


def _check_leaves(tree, where="params"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_leaves(v, f"{where}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _check_leaves(v, f"{where}.{i}")
    elif getattr(tree, "dtype", None) is not None and \
            tree.dtype.kind not in "fiub":
        raise TypeError(f"checkpoint leaf {where} has dtype {tree.dtype}; "
                        "the port loads float32/float16 (and integer) "
                        "leaves only")


def load_checkpoint(path: str) -> dict:
    """``path`` may be a step dir or a run dir (follows ``latest``).
    Returns ``{"step", "params", ...}`` with numpy leaves."""
    path = os.path.join(_resolve(path), "state.pkl")
    try:
        with open(path, "rb") as f:
            state = pickle.load(f)
    except ModuleNotFoundError as err:
        raise TypeError(
            f"{path} needs module {err.name!r} to unpickle — a bfloat16 "
            "(ml_dtypes) tree from --param_dtype bfloat16; re-save it in "
            "float32 to evaluate it in the port") from err
    _check_leaves(state["params"])
    return state
