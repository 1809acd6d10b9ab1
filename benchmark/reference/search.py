"""Exact maximum-inner-product search in float32 (TF32 off) over rows given
chunk by chunk: a running top-k, and the exact score of any row asked for,
in one pass."""

from __future__ import annotations

import torch

from .precision import Matmul


def scan(queries: torch.Tensor, chunks, k: int, probe: torch.Tensor | None
         = None, mm: Matmul | None = None):
    """``queries`` (Q, d); ``chunks`` yields (start, (rows, d) f32);
    ``probe`` (Q, m) row ids whose exact scores are wanted.
    -> (top scores (Q, k), top ids (Q, k) int64, probe scores (Q, m)),
    scores descending, ties to the lower id."""
    mm = mm or Matmul("f32")
    q = queries.to(torch.float32)
    dev = q.device
    best_s = torch.full((q.shape[0], k), float("-inf"), device=dev)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=dev)
    got = None if probe is None else torch.full(probe.shape, float("nan"),
                                                device=dev)
    for start, rows in chunks:
        s = mm.mm(q, rows.T)
        # the chunk's own top k (exact: a row outside it cannot enter the
        # merged top k), then the merge of 2k candidates
        part_s, part_i = torch.topk(s, min(k, s.shape[1]), dim=1)
        cat_s = torch.cat([best_s, part_s], dim=1)
        cat_i = torch.cat([best_i, part_i + start], dim=1)
        # descending score, then ascending id: sort by id first, stably
        order = torch.argsort(cat_i, dim=1)
        cat_s, cat_i = cat_s.gather(1, order), cat_i.gather(1, order)
        top = torch.argsort(cat_s, dim=1, descending=True, stable=True)[:, :k]
        best_s, best_i = cat_s.gather(1, top), cat_i.gather(1, top)
        if probe is not None:
            inside = (probe >= start) & (probe < start + rows.shape[0])
            if inside.any():
                r, c = torch.nonzero(inside, as_tuple=True)
                got[r, c] = s[r, probe[r, c] - start]
    return best_s, best_i, got
