"""Training statistics aggregation (reference: src/util.py:378-415
``WeightedAvgStats`` + distributed weighted averaging).

Counterpart of ``jsa_rag_tpu/utils/stats.py``: across processes the
averages align on the union of every rank's keys first (``stats.py:42-77``:
a rank that saw only dummy batches holds none), so every rank issues the
same collectives whatever its keys."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Tuple

import torch

from ..parallel import mesh


class WeightedAvgStats:
    """Weighted running averages over (value, weight) stat dicts."""

    def __init__(self):
        self.raw_stats: Dict[str, float] = defaultdict(float)
        self.total_weights: Dict[str, float] = defaultdict(float)

    def update(self, vals: Dict[str, Tuple[float, float]]) -> None:
        for key, (value, weight) in vals.items():
            self.raw_stats[key] += float(value) * float(weight)
            self.total_weights[key] += float(weight)

    @property
    def stats(self) -> Dict[str, float]:
        return {k: self.raw_stats[k] / max(self.total_weights[k], 1e-12)
                for k in self.raw_stats}

    @property
    def tuple_stats(self) -> Dict[str, Tuple[float, float]]:
        return {k: (self.raw_stats[k] / max(self.total_weights[k], 1e-12),
                    self.total_weights[k])
                for k in self.raw_stats}

    def reset(self) -> None:
        self.raw_stats = defaultdict(float)
        self.total_weights = defaultdict(float)

    @property
    def average_stats(self) -> Dict[str, float]:
        """Cross-process weighted average over the union of the ranks' keys
        (a collective every rank calls); with one process, the local
        stats."""
        if mesh.process_count() == 1:
            return self.stats
        payload = json.dumps(sorted(self.raw_stats.keys())).encode()
        codes = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        rows, counts = mesh.all_gather_ragged(codes.to(mesh.comm_device()))
        keys: set = set()
        for row, n in zip(rows.cpu(), counts):
            keys.update(json.loads(bytes(row[:n].tolist()).decode()))
        keys = sorted(keys)
        if not keys:
            return {}
        summed = mesh.all_sum(
            [x for k in keys for x in (self.raw_stats.get(k, 0.0),
                                       self.total_weights.get(k, 0.0))])
        return {k: summed[2 * i] / max(summed[2 * i + 1], 1e-12)
                for i, k in enumerate(keys)}


def weighted_average(value: float, weight: float) -> tuple[float, float]:
    """``dist_utils.weighted_average`` (src/dist_utils.py:168-178,
    ``stats.py:79-91``): the weight-averaged value over every rank and the
    total weight."""
    if mesh.process_count() == 1:
        return value, weight
    total = mesh.all_sum([value * weight, weight])
    return float(total[0] / max(total[1], 1e-12)), float(total[1])

