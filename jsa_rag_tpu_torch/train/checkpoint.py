"""Checkpoints in the JAX package's layout (counterpart of
``jsa_rag_tpu/train/checkpoint.py``), so either package resumes or
evaluates the other's.

A checkpoint is ``<run>/step-N/state.pkl`` (``{"step", "params"}``, the
JAX param pytree with numpy leaves, ``convert.params_to_numpy``) beside
``options.json``, ``tokenizer.json`` / ``retriever_tokenizer.json``, with a
``latest`` symlink in the run dir; ``export_retriever`` writes the towers
alone under ``bge_<tower>_Embedding_Ret/step-N`` with a ``lastest`` (sic)
symlink (train.py:335-372). Writes can queue on one background thread
(``block=False``): the host copy happens on the caller's thread, the disk
IO in submission order; ``wait_for_writes`` joins it and re-raises a failed
write. With ``--save_optimizer`` the state also holds ``opt_state``: the
port's ``AdamW.state_dict()`` (plain dicts of numpy arrays and ints, which
the JAX package's ``load_checkpoint`` reads too).

Leaves are saved as float32 numpy arrays whatever their dtype: a bf16 leaf
(``--param_dtype bfloat16``) as the float32 array of the same values, which
is lossless, needs no ml_dtypes package and loads in both packages (the
loader's ``param_dtype`` cast gives the same bits back). Leaves stored in
float32 or float16 load; a JAX tree saved under ``--param_dtype bfloat16``
holds ml_dtypes bf16 arrays, which load as float32 where ml_dtypes is
installed and raise a clear error where it is not (the card). A JAX
checkpoint saved with ``--save_optimizer`` pickles its
``opt_state`` as optax (and jax) classes; ``load_checkpoint`` unpickles
those as inert stand-ins and drops ``opt_state``, so its step and params
load where neither package is installed. Only load checkpoints this project
wrote: unpickling runs code.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import pickle
import threading
from typing import Any

import numpy as np

from ..convert import params_to_numpy, retriever_params_to_numpy
from ..data.tokenizer import SimpleTokenizer

logger = logging.getLogger(__name__)


class _AsyncWriter:
    """FIFO background writer (``checkpoint.py:31-81``): ``submit`` never
    blocks; jobs run in order on one non-daemon thread that exits when
    drained; the first failed job's error re-raises on the next ``join``."""

    def __init__(self):
        self._jobs = collections.deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def submit(self, fn) -> None:
        with self._cv:
            self._jobs.append(fn)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-writer", daemon=False)
                self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._jobs:
                    self._thread = None
                    self._cv.notify_all()
                    return
                fn = self._jobs.popleft()
            try:
                fn()
            except BaseException as e:  # surfaced on the next join
                with self._cv:
                    if self._err is None:
                        self._err = e

    def join(self) -> None:
        with self._cv:
            while self._jobs or self._thread is not None:
                self._cv.wait(timeout=0.1)
            if self._err is not None:
                err, self._err = self._err, None
                raise err


_writer = _AsyncWriter()


def wait_for_writes() -> None:
    """Block until queued checkpoint writes finish (re-raising a failure)."""
    _writer.join()


def symlink_force(target: str, link: str) -> None:
    """Atomic symlink replace: a temp-named link ``os.replace``d over the
    destination, so the run is never without its ``latest`` link."""
    tmp = f"{link}.tmp.{os.getpid()}"
    try:
        os.symlink(target, tmp)
        os.replace(tmp, link)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _dump_pickle(obj, path: str) -> None:
    """tmp + rename: a crash cannot leave a truncated pickle behind."""
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    os.replace(tmp, path)


def save_checkpoint(path: str, name: str, step: int, params: dict,
                    opt_state: Any = None, options: Any = None,
                    tokenizer: Any = None, retriever_tokenizer: Any = None,
                    block: bool = True) -> str:
    """Write ``<path>/<name>/step-<step>`` and repoint ``latest``; returns
    the step dir. The host copy of ``params`` (and of ``opt_state``, an
    ``AdamW.state_dict()``) is taken here; with ``block=False`` the disk IO
    queues on the background writer."""
    run_dir = os.path.join(path, name)
    step_dir = os.path.join(run_dir, f"step-{step}")
    state = {"step": step, "params": params_to_numpy(params)}
    if opt_state is not None:
        state["opt_state"] = opt_state

    def write():
        os.makedirs(step_dir, exist_ok=True)
        _dump_pickle(state, os.path.join(step_dir, "state.pkl"))
        if options is not None:
            options.dump(os.path.join(step_dir, "options.json"))
        for tok, fname in ((tokenizer, "tokenizer.json"),
                           (retriever_tokenizer,
                            "retriever_tokenizer.json")):
            if tok is not None and hasattr(tok, "to_dict"):
                with open(os.path.join(step_dir, fname), "w") as f:
                    json.dump(tok.to_dict(), f)
        # flip latest only after every artifact of the step is on disk
        symlink_force(f"step-{step}", os.path.join(run_dir, "latest"))

    if block:
        _writer.join()  # never reorder behind a queued write
        write()
    else:
        _writer.submit(write)
    return step_dir


def export_retriever(path: str, step: int, retriever, tokenizer: Any = None,
                     prefix: str = "bge", block: bool = True) -> None:
    """The retriever's towers alone, one pickle per tower, with a
    ``lastest`` symlink per tower (``checkpoint.py:219-259``)."""
    host = retriever_params_to_numpy(retriever)

    def write():
        for tower in list(host):
            host_tower = host.pop(tower)  # free as written
            root = os.path.join(path, f"{prefix}_{tower}_Embedding_Ret")
            step_dir = os.path.join(root, f"step-{step}")
            os.makedirs(step_dir, exist_ok=True)
            _dump_pickle(host_tower, os.path.join(step_dir, "params.pkl"))
            if tokenizer is not None and hasattr(tokenizer, "to_dict"):
                with open(os.path.join(step_dir, "tokenizer.json"),
                          "w") as f:
                    json.dump(tokenizer.to_dict(), f)
            symlink_force(f"step-{step}", os.path.join(root, "lastest"))

    if block:
        _writer.join()
        write()
    else:
        _writer.submit(write)


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


def _checked_leaves(tree, where="params"):
    """The tree with ml_dtypes bfloat16 leaves read as float32 (exact);
    any other non-numeric leaf raises."""
    if isinstance(tree, dict):
        return {k: _checked_leaves(v, f"{where}.{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_checked_leaves(v, f"{where}.{i}")
                for i, v in enumerate(tree)]
    dtype = getattr(tree, "dtype", None)
    if dtype is not None and dtype.name == "bfloat16":
        return tree.astype(np.float32)
    if dtype is not None and dtype.kind not in "fiub":
        raise TypeError(f"checkpoint leaf {where} has dtype {dtype}; "
                        "the port loads float32/float16/bfloat16 (and "
                        "integer) leaves only")
    return tree


class _Inert:
    """What a JAX checkpoint's optax / jax class unpickles to: it takes any
    constructor arguments and state and does nothing with them."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


def _stand_in(module: str, name: str) -> type:
    return type(name, (_Inert,), {"__module__": module})


class _Unpickler(pickle.Unpickler):
    """Unpickles optax's and jax's classes (a JAX ``opt_state``) as inert
    stand-ins, so a checkpoint's step and params load where neither package
    can be imported; every other class resolves as ``pickle`` would."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("optax", "jax", "jaxlib", "chex"):
            return _stand_in(module, name)
        return super().find_class(module, name)


def load_checkpoint(path: str) -> dict:
    """``path`` may be a step dir or a run dir (follows ``latest``).
    Returns ``{"step", "params", ...}`` with numpy leaves; an
    ``opt_state`` in the JAX package's optax form is dropped (logged), the
    port's own form is kept for ``set_optim``."""
    path = os.path.join(_resolve(path), "state.pkl")
    try:
        with open(path, "rb") as f:
            state = _Unpickler(f).load()
    except ModuleNotFoundError as err:
        raise TypeError(
            f"{path} needs module {err.name!r} to unpickle — a bfloat16 "
            "(ml_dtypes) tree the JAX package saved under --param_dtype "
            "bfloat16; install ml_dtypes, or re-save it in float32, to load "
            "it in the port") from err
    state["params"] = _checked_leaves(state["params"])
    opt_state = state.get("opt_state")
    if opt_state is not None and not (
            isinstance(opt_state, dict) and "format" in opt_state):
        del state["opt_state"]
        logger.info("dropped the JAX package's optax opt_state of %s: the "
                    "port restores only its own optimizer state", path)
    return state
