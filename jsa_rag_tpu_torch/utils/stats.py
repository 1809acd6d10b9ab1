"""Training statistics aggregation (reference: src/util.py:378-415
``WeightedAvgStats`` + distributed weighted averaging).

Counterpart of ``jsa_rag_tpu/utils/stats.py`` for one process: the
cross-process reductions (``stats.py:44,82``) are identities here; several
processes arrive with ``torch.distributed`` (ROADMAP queue A item 13)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple


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
        """Cross-process weighted average; with one process, the local
        stats."""
        return self.stats

