"""Incremental (double-buffered) index refresh (counterpart of
``jsa_rag_tpu/index/refresh.py``).

When the refresh schedule fires, a staging store shaped like the live one is
allocated and a sweep cursor starts; each training step then embeds
``batches_per_step`` passage batches with the current passage tower and
writes them into the staging store through ``index.write_block``; when the
sweep has covered the corpus, the staging store becomes the live one
(``index.swap_in``) and the old store is freed. Training never stalls for a
full re-embed; passages embedded early in a sweep use slightly older
weights than later ones, as in the reference's asynchronous rebuild.

Over several processes each rank embeds the passages of its own shard
into its own staging store. The sweep's length in batches is the largest
shard's, the same number on every rank (a rank whose shard is shorter
idles through the rest), so every rank swaps on the same step.

Memory: one more store during a sweep (float16 at 1.3M x 1024: +2.66 GB).
Works for every flat storage: float16, int8r, int8, hybrid (its int8
coarse copy is derived again from the swapped-in rows) and bf16/f32.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..data.passages import format_passage
from .flat import ShardedFlatIndex

logger = logging.getLogger(__name__)


class IncrementalIndexRefresher:
    def __init__(self, model, index: ShardedFlatIndex,
                 batches_per_step: int = 4):
        if not isinstance(index, ShardedFlatIndex):
            raise ValueError("incremental refresh supports the flat index")
        self.model = model
        self.index = index
        self.batches_per_step = batches_per_step
        self._staging = None
        self._staging_aux = None
        self._cursor = 0  # batches of the sweep taken, on every rank

    @property
    def active(self) -> bool:
        return self._staging is not None

    def start(self) -> None:
        """Allocate the staging store and reset the sweep cursor."""
        idx = self.index
        self._staging = torch.zeros_like(idx.embeddings)
        if idx.store_int8r:
            # write_block's int8r aux is the (scales, res, res_scales) tuple
            self._staging_aux = (torch.zeros_like(idx.scales),
                                 torch.zeros_like(idx.res),
                                 torch.zeros_like(idx.res_scales))
        elif idx.store_int8:
            self._staging_aux = torch.zeros_like(idx.scales)
        self._cursor = 0
        logger.info("incremental index refresh started (%d passages)",
                    idx.n_passages)

    def step(self, params) -> bool:
        """Embed up to ``batches_per_step`` batches into the staging store;
        swap it in and return True when the sweep completes."""
        if not self.active:
            return False
        model, idx = self.model, self.index
        opt = model.opt
        bs = opt.per_gpu_embedder_batch_size
        tower = params["retriever"]
        # the sweep: the largest shard's batches; this rank's rows
        n_batches = -(-min(idx.shard_rows, idx.n_passages) // bs)
        last = idx.row_offset + idx.local_rows
        for _ in range(self.batches_per_step):
            if self._cursor >= n_batches:
                break
            start = idx.row_offset + self._cursor * bs
            stop = min(start + bs, last)
            self._cursor += 1
            if start >= stop:
                continue  # a shorter shard idles to the sweep's end
            texts = [format_passage(model.store[i], opt.retriever_format)
                     for i in range(start, stop)]
            ids, mask = model.retriever_tokenizer.encode_batch(
                texts, model._retriever_max_len())
            if stop - start < bs:
                ids = np.pad(ids, ((0, bs - (stop - start)), (0, 0)))
                mask = np.pad(mask, ((0, bs - (stop - start)), (0, 0)))
            # the batch cut to its longest row rounded up to 64 tokens, as
            # build_index cuts its batches
            used = int(mask.sum(axis=1).max()) if mask.size else 1
            b_len = min(-(-max(used, 1) // 64) * 64, ids.shape[1])
            ids, mask = ids[:, :b_len], mask[:, :b_len]
            with torch.no_grad():
                emb = tower.embed_passages(
                    torch.from_numpy(ids).to(idx.device),
                    torch.from_numpy(mask).to(idx.device))
            self._staging, self._staging_aux = idx.write_block(
                self._staging, self._staging_aux, start, emb[:stop - start])
        if self._cursor < n_batches:
            return False
        idx.swap_in(self._staging, self._staging_aux)
        self._staging = self._staging_aux = None
        logger.info("incremental index refresh swapped in")
        return True
