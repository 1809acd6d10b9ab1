"""Synthetic corpora for the end-to-end benches, made in bulk from a seed.

A store of millions of passage dicts takes minutes to build one by one
(``PassageStore.synthetic`` draws each passage's words separately), so
these hold the word ids of every passage in one flat array, drawn with one
call, and build a passage's dict when it is read. They answer the
``PassageStore`` calls the model, the index build and the server make:
``len``, ``store[i]``, ``get_many`` and ``texts``.
"""

from __future__ import annotations

import numpy as np

from ..data.passages import format_passage


class SyntheticPassages:
    """Passage i: ``{"id": str(i), "title": title_fmt.format(i % 101),
    "text": "w<a> w<b> ..."}``, ``lens[i]`` words drawn uniformly from
    ``n_words``."""

    def __init__(self, lens: np.ndarray, n_words: int,
                 rng: np.random.Generator, title_fmt: str):
        self.bounds = np.concatenate([[0], np.cumsum(lens)])
        self.words = rng.integers(0, n_words, int(self.bounds[-1]),
                                  dtype=np.int32)
        self.title_fmt = title_fmt

    def __len__(self) -> int:
        return len(self.bounds) - 1

    def __getitem__(self, i: int) -> dict:
        i = int(i)
        if not 0 <= i < len(self):
            raise IndexError(i)
        ids = self.words[self.bounds[i]:self.bounds[i + 1]].tolist()
        return {"id": str(i), "title": self.title_fmt.format(i % 101),
                "text": " ".join(f"w{j}" for j in ids)}

    def get_many(self, ids) -> list[dict]:
        return [self[i] for i in ids]

    def texts(self, fmt: str = "{title} {text}"):
        for i in range(len(self)):
            yield format_passage(self[i], fmt)


def uniform_passages(n: int, seed: int = 0) -> SyntheticPassages:
    """``PassageStore.synthetic``'s shape: 8-39 words of 997, titles
    ``title <i % 101>``."""
    rng = np.random.default_rng(seed)
    return SyntheticPassages(rng.integers(8, 40, size=n), 997, rng,
                             "title {}")


def wiki_like_passages(n: int, seed: int = 0) -> SyntheticPassages:
    """Word counts like wiki 100-word passages in wordpieces: normal(155,
    18) clipped to [110, 230], 4,999 words (``embed_bench.py:24-43``)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.normal(155, 18, size=n), 110, 230).astype(int)
    return SyntheticPassages(lens, 4999, rng, "t {}")


class NumberedPassages:
    """Passage i: ``{"id": str(i), "title": f"t{i}", "text": f"passage body
    {i}"}`` (``serve_bench.py:64-69``)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        i = int(i)
        if not 0 <= i < self.n:
            raise IndexError(i)
        return {"id": str(i), "title": f"t{i}", "text": f"passage body {i}"}
