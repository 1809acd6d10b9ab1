"""npy IO of the saved index (counterpart of ``jsa_rag_tpu/index/_npio.py``).

The shards are plain ``.npy`` files. int8r storage writes int8 and float32
only; a bfloat16 shard of the JAX package (stored as uint16 bits, or with
numpy's raw ``|V2`` descr) reads back as its uint16 bit pattern, since the
port carries no ml_dtypes.
"""

from __future__ import annotations

import numpy as np


def np_save(path: str, arr: np.ndarray) -> None:
    np.save(path, np.asarray(arr))


def np_load(path: str) -> np.ndarray:
    a = np.load(path)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = a.view(np.uint16)
    return a
