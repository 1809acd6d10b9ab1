"""Dual-encoder retriever: query and passage towers over the BERT encoder.

Counterpart of ``jsa_rag_tpu/models/retriever.py``. Tied towers live under
``shared``, untied ones under ``query`` and ``passage`` — the JAX pytree's
top-level keys, so the state dict's keys are the pytree's paths.
``query_side_only`` detaches the passage tower's output (the JAX package's
stop_gradient). A retriever can also be assembled from towers that already
exist (``towers=``): the posterior of the jsa/vrag modes (``make_posterior``)
and, under ``decouple_encoder``, the view that pairs the posterior's query
tower with the prior's passage tower.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from .bert import BertConfig, BertEncoder


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    tied: bool = False
    query_side_only: bool = False


class DualEncoderRetriever(nn.Module):
    def __init__(self, cfg: RetrieverConfig, *, device="cuda",
                 generator: torch.Generator | None = None,
                 towers: dict[str, BertEncoder] | None = None):
        """Towers on ``device``, N(0, 0.02)-initialised from ``generator``
        (query tower first) or zero-initialised for loading without one;
        or the given ``towers`` ({"query", "passage", "shared"} subset),
        shared with their owner, not copied."""
        super().__init__()
        self.cfg = cfg
        if towers is not None:
            for name, tower in towers.items():
                setattr(self, name, tower)
            return
        dev = resolve_device(device)
        if cfg.tied:
            self.shared = BertEncoder(cfg.bert, device=dev,
                                      generator=generator)
        else:
            self.query = BertEncoder(cfg.bert, device=dev,
                                     generator=generator)
            self.passage = BertEncoder(cfg.bert, device=dev,
                                       generator=generator)

    def _tower(self, is_passages: bool) -> BertEncoder:
        if self.cfg.tied:
            return self.shared
        return self.passage if is_passages else self.query

    def embed(self, input_ids, attention_mask, *, is_passages: bool,
              rng=None):
        """(B, S) ids -> (B, H) embeddings; ``rng`` (a CPU generator) turns
        on train-time dropout."""
        out = self._tower(is_passages)(input_ids, attention_mask, rng)
        if is_passages and self.cfg.query_side_only:
            return out.detach()
        return out

    def embed_queries(self, input_ids, attention_mask, rng=None):
        return self.embed(input_ids, attention_mask, is_passages=False,
                          rng=rng)

    def embed_passages(self, input_ids, attention_mask, rng=None):
        return self.embed(input_ids, attention_mask, is_passages=True,
                          rng=rng)

    def tower_names(self) -> list[str]:
        return [n for n in ("shared", "query", "passage") if hasattr(self, n)]


def make_posterior(prior: DualEncoderRetriever, *,
                   decouple: bool) -> DualEncoderRetriever:
    """The posterior retriever of the vrag/jsa modes (``retriever.py:87-101``):
    an independent copy of the prior's towers, or with ``decouple`` its query
    tower only (the passage tower is the prior's, paired in by
    ``train/modes.py::ApplyFns.expand``)."""
    names = [n for n in prior.tower_names()
             if not (decouple and n == "passage")]
    return DualEncoderRetriever(
        prior.cfg, towers={n: copy.deepcopy(getattr(prior, n))
                           for n in names})


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(
        x.to(torch.float32), dim=dim, keepdim=True).clamp_min(1e-12).to(
            x.dtype)
