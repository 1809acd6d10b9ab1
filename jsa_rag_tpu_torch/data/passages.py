"""Host-side passage storage: id -> {title, text} resolution.

The port's own copy of ``jsa_rag_tpu/data/passages.py`` (framework-neutral;
copied so the port imports nothing of the JAX package).

The device program only ever sees int32 passage ids (design rule from
SURVEY.md: never move strings through collectives — the reference pickles
passage dicts into uint8 CUDA tensors, src/index.py:34-41, which we
deliberately do not reproduce). This module is the host half: jsonl ingestion
(reference: src/index_io.py:17-47 ``load_passages``) and an optional
C++-backed memory-mapped store (native/passage_store.cpp) for 21M-passage
corpora where a Python list of dicts is too heavy.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Sequence


def load_passages_jsonl(
    paths: Sequence[str] | str,
    rank: int = 0,
    world_size: int = 1,
) -> list[dict]:
    """Load passages from jsonl file(s); round-robin sharding by line counter
    matches the reference (src/index_io.py:41: ``counter % world_size ==
    global_rank``). Each line: {"id": ..., "title": ..., "text": ...}."""
    if isinstance(paths, str):
        paths = [paths]
    out = []
    counter = 0
    for path in paths:
        with open(path) as f:
            for line in f:
                if counter % world_size == rank:
                    out.append(json.loads(line))
                counter += 1
    return out


def format_passage(p: dict, fmt: str = "{title} {text}") -> str:
    """Passage -> encoder input string (reference's ``passage_format``,
    src/options.py:361-366 and src/rag.py:108-117)."""
    return fmt.format(title=p.get("title", ""), text=p.get("text", ""))


class PassageStore:
    """Uniform id -> passage interface over either an in-memory list or the
    native mmap store. Ids are positions in the global corpus order."""

    def __init__(self, passages: list[dict] | None = None, mmap_path: str | None = None):
        if (passages is None) == (mmap_path is None):
            raise ValueError("exactly one of passages / mmap_path")
        self._list = passages
        self._native = None
        if mmap_path is not None:
            from . import native_store

            self._native = native_store.NativePassageStore(mmap_path)

    def __len__(self) -> int:
        if self._native is not None:
            return len(self._native)
        return len(self._list)

    def __getitem__(self, i: int) -> dict:
        if self._native is not None:
            return self._native[int(i)]
        return self._list[int(i)]

    def get_many(self, ids: Iterable[int]) -> list[dict]:
        return [self[i] for i in ids]

    def texts(self, fmt: str = "{title} {text}") -> Iterable[str]:
        for i in range(len(self)):
            yield format_passage(self[i], fmt)

    @classmethod
    def from_jsonl(cls, paths, rank: int = 0, world_size: int = 1):
        return cls(passages=load_passages_jsonl(paths, rank, world_size))

    @classmethod
    def synthetic(cls, n: int, seed: int = 0) -> "PassageStore":
        """Deterministic synthetic corpus for tests/benchmarks."""
        import numpy as np

        rng = np.random.default_rng(seed)
        words = [f"w{i}" for i in range(997)]
        passages = []
        for i in range(n):
            k = rng.integers(8, 40)
            text = " ".join(rng.choice(words, size=k).tolist())
            passages.append(
                {"id": str(i), "title": f"title {i % 101}", "text": text}
            )
        return cls(passages=passages)
