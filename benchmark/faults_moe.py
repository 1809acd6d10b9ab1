"""The DeepSeek-V2 training cell's faults, as ``faults.py`` gives the other
cells' (planted under a whole run, to show that ``correct`` catches them):
``faults.train``'s four, since the cell's step is the flagship's, and

- ``routes_altered``: every router's choices moved one expert on, where
  they are produced (``models/lm.py::route``).
"""

from __future__ import annotations

import contextlib

from . import faults

KINDS = faults.FAULTS["train_jsa"][1] + ("routes_altered",)


@contextlib.contextmanager
def _routes_altered():
    from jsa_rag_tpu_torch.models import lm

    real = lm.route

    def route(h, w, k):
        weights, ids = real(h, w, k)
        return weights, (ids + 1) % w.shape[1]

    with faults.patched(lm, "route", route):
        yield


def train_moe(kind: str):
    if kind == "routes_altered":
        return _routes_altered()
    return faults.train(kind)
