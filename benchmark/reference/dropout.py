"""Train-time dropout masks, made again from their seeds.

A model call that drops out takes one seed a site (BERT: the embeddings,
then each layer's attention probabilities, attention output and FFN
output; the generator: each layer's attention probabilities) and draws the
site's mask over the call's padded shape as ``torch.rand(shape,
generator=<a generator on the device seeded with the seed>) < 1 - rate``,
keeping what it keeps scaled by ``1 / (1 - rate)``. The seeds and shapes
are data: the benchmark records those a run drew, or the reference draws
its own where it runs in the program's place. The reference runs each
sequence at its real length, so it takes its rows of the call's mask and
the leading entries of each further axis.
"""

from __future__ import annotations

import torch


class Drop:
    """The masks of one model call: ``seeds[i]`` and ``shapes[i]`` are
    site ``i``'s seed and the shape its mask was drawn at."""

    def __init__(self, rate: float, seeds: list, shapes: list):
        if len(seeds) != len(shapes):
            raise ValueError("a seed a site, and a shape a seed")
        self.rate, self.seeds, self.shapes = float(rate), seeds, shapes

    def apply(self, site: int, x: torch.Tensor, rows) -> torch.Tensor:
        """``x`` (len(rows), ...) with site ``site``'s mask applied: the
        mask's rows ``rows``, cut to ``x``'s sizes. A mask of one axis more
        than ``x`` is the generator's grouped heads (B, G, R, S, S), read as
        (B, G * R, S, S)."""
        rows = list(rows)
        if max(rows) >= self.shapes[site][0]:
            raise ValueError(f"row {max(rows)} of a call that drew masks "
                             f"for {self.shapes[site][0]} rows")
        g = torch.Generator(device=x.device).manual_seed(
            int(self.seeds[site]))
        keep = torch.rand(tuple(self.shapes[site]), generator=g,
                          device=x.device) < 1.0 - self.rate
        if keep.dim() == x.dim() + 1:
            keep = keep.flatten(1, 2)
        keep = keep[torch.as_tensor(rows, device=x.device)]
        keep = keep[(slice(None),) + tuple(slice(0, n) for n in x.shape[1:])]
        return torch.where(keep, x / (1.0 - self.rate), 0.0)

    def record(self) -> dict:
        return {"seeds": list(self.seeds),
                "shapes": [tuple(s) for s in self.shapes]}


def draw(gen: torch.Generator, rate: float, shapes: list) -> Drop:
    """The reference's own masks for a call (where it runs in the program's
    place): one seed a site from the CPU generator ``gen``."""
    seeds = torch.randint(0, 2 ** 62, (len(shapes),), generator=gen).tolist()
    return Drop(rate, seeds, shapes)


def bert_shapes(c: dict, rows: int, length: int) -> list[tuple]:
    """The sites' shapes of a BERT call over ``rows`` sequences padded to
    ``length``."""
    h, nh = c["hidden_size"], c["num_attention_heads"]
    per = [(rows, nh, length, length), (rows, length, h), (rows, length, h)]
    return [(rows, length, h)] + per * c["num_hidden_layers"]


def generator_shapes(c: dict, rows: int, length: int) -> list[tuple]:
    """The sites' shapes of a generator call: grouped heads, (B, G, R, S,
    S), a layer."""
    g = c["num_key_value_heads"]
    r = c["num_attention_heads"] // g
    return [(rows, g, r, length, length)] * c["num_hidden_layers"]
