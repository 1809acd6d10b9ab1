"""Dual-encoder retriever: query and passage towers over the BERT encoder.

Counterpart of ``jsa_rag_tpu/models/retriever.py``. Tied towers live under
``shared``, untied ones under ``query`` and ``passage`` — the JAX pytree's
top-level keys, so the state dict's keys are the pytree's paths.
``query_side_only`` runs the passage tower without autograd (the JAX
package's stop_gradient).
"""

from __future__ import annotations

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
                 generator: torch.Generator | None = None):
        """Towers on ``device``, N(0, 0.02)-initialised from ``generator``
        (query tower first) or zero-initialised for loading without one."""
        super().__init__()
        self.cfg = cfg
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

    def embed(self, input_ids, attention_mask, *, is_passages: bool):
        """(B, S) ids -> (B, H) embeddings."""
        tower = self._tower(is_passages)
        if is_passages and self.cfg.query_side_only:
            with torch.no_grad():
                return tower(input_ids, attention_mask)
        return tower(input_ids, attention_mask)

    def embed_queries(self, input_ids, attention_mask):
        return self.embed(input_ids, attention_mask, is_passages=False)

    def embed_passages(self, input_ids, attention_mask):
        return self.embed(input_ids, attention_mask, is_passages=True)


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(
        x.to(torch.float32), dim=dim, keepdim=True).clamp_min(1e-12).to(
            x.dtype)
