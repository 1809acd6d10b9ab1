"""npy IO of the saved index (counterpart of ``jsa_rag_tpu/index/_npio.py``).

The shards are plain ``.npy`` files. int8r storage writes int8 and float32
only; a bfloat16 shard of the JAX package (stored as uint16 bits, or with
numpy's raw ``|V2`` descr) reads back as its uint16 bit pattern, since the
port carries no ml_dtypes. ``np_load(path, "bfloat16")`` re-views those bits
as a ``torch.bfloat16`` tensor (numpy has no bfloat16): an IVF directory's
dense bf16 clusters are saved so, and a value cast would turn 0.5 into
16128.0.
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, 16-bit floats as their bits, as the JAX package
    writes them: bfloat16 as uint16, float16 as int16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def np_save(path: str, arr: np.ndarray) -> None:
    np.save(path, np.asarray(arr))


def _is_bf16(dtype) -> bool:
    return dtype is not None and (dtype == torch.bfloat16
                                  or str(dtype) == "bfloat16")


def np_load(path: str, dtype=None):
    """The array at ``path``; a raw ``|V2`` shard reads as uint16 bits.
    With ``dtype`` bfloat16 a uint16 shard comes back as a torch.bfloat16
    tensor of the same bits; otherwise a numpy array."""
    a = np.load(path)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(np.uint16)
    if _is_bf16(dtype) and a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return a
