"""Index build: embed the corpus with the passage tower and write it into the
index (counterpart of ``jsa_rag_tpu/index/build.py``, :27-158).

Host tokenisation runs ``prefetch`` windows ahead of the device on a
thread pool; each window of ``sort_window`` batches is ordered by token
count so every batch is cut to its own length bucket, and the embeddings are
put back in corpus order (one gather) before the contiguous write.

Over several processes each rank embeds only the passages of its own shard
of a flat index (``index.row_offset``, ``index.local_rows``): the same rows
a one-process build writes there, in windows cut from the shard's start.
Nothing here is collective, so ranks need not build in step.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from ..data.passages import PassageStore, format_passage
from ..utils import trace
from .flat import ShardedFlatIndex


def build_index(
    index: ShardedFlatIndex,
    passages: PassageStore,
    encode_fn: Callable,  # (ids, mask) tensors on index.device -> (B, d)
    tokenizer,
    batch_size: int = 256,
    max_length: int = 256,
    passage_fmt: str = "{title} {text}",
    logger=None,
    prefetch: int = 2,
    length_bucket: int = 64,
    sort_window: int = 8,
    finalize: bool = True,
) -> dict:
    """Embed every passage and fill the index at its own row. Returns
    timing stats.

    ``length_bucket``: each batch is cut to its longest row rounded up to
    this multiple (0 disables). ``sort_window``: tokenise that many batches
    at a time and order their rows by length (1 disables). ``finalize``:
    an index with a coarse quantiser (IVF) trains it after the sweep, as
    the reference trains FAISS after the fill (src/rag.py:122-130); the
    stats then split ``runtime/indexing`` into ``indexing/embed_s`` and
    ``indexing/finalize_s``."""
    n = len(passages)
    dev = index.device
    t0 = time.time()
    window = batch_size * max(sort_window, 1)
    # a sharded flat index: this rank's rows only (of the corpus, which
    # may be shorter than the index)
    first = min(getattr(index, "row_offset", 0), n)
    last = min(first + getattr(index, "local_rows", n), n)
    spans = [(s, min(s + window, last)) for s in range(first, last, window)]

    def tokenize_window(span):
        start, stop = span
        texts = [format_passage(passages[i], passage_fmt)
                 for i in range(start, stop)]
        ids, mask = tokenizer.encode_batch(texts, max_length)
        n_batches = -(-(stop - start) // batch_size)
        n_rows = n_batches * batch_size
        if stop - start < n_rows:  # whole batches: stable request shapes
            pad = n_rows - (stop - start)
            ids = np.pad(ids, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
        counts = mask.sum(axis=1)
        # stable sort keeps corpus order within equal lengths; pad rows
        # (count 0) sort first and fall off the tail slice after the unsort
        order = np.argsort(counts, kind="stable")
        inv = np.argsort(order)
        batches = []
        for j in range(n_batches):
            rows = order[j * batch_size:(j + 1) * batch_size]
            b_ids, b_mask = ids[rows], mask[rows]
            if length_bucket:
                used = int(counts[rows].max())
                b_len = min(
                    -(-max(used, 1) // length_bucket) * length_bucket,
                    ids.shape[1])
                b_ids, b_mask = b_ids[:, :b_len], b_mask[:, :b_len]
            batches.append((b_ids, b_mask))
        return start, stop, batches, inv

    # one worker: the windows are tokenised in corpus order, so a growable
    # vocabulary (SimpleTokenizer numbers a word when it first meets it)
    # gives every run the same ids; two workers raced on it
    with ThreadPoolExecutor(max_workers=1) as ex:
        futures = [ex.submit(tokenize_window, span)
                   for span in spans[:prefetch]]
        next_submit = prefetch
        for _ in range(len(spans)):
            with trace.span("build.wait_tokens"):
                start, stop, batches, inv = futures.pop(0).result()
            if next_submit < len(spans):
                futures.append(ex.submit(tokenize_window, spans[next_submit]))
                next_submit += 1
            embs = []
            for ids, mask in batches:
                with trace.span("build.h2d"):
                    ids = torch.from_numpy(ids).to(dev)
                    mask = torch.from_numpy(mask).to(dev)
                with trace.span("build.encode"):
                    embs.append(encode_fn(ids, mask))
            with trace.span("build.write"):
                block = _unsort_rows(embs, torch.from_numpy(inv).to(dev))
                index.set_embeddings(start, block[: stop - start])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats = {}
    if finalize and hasattr(index, "finalize"):
        t1 = time.time()
        index.finalize()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stats = {"indexing/embed_s": (t1 - t0, 1),
                 "indexing/finalize_s": (time.time() - t1, 1)}
    total = time.time() - t0
    return {
        "runtime/indexing": (total, 1),
        "indexing/passages_per_sec": ((last - first) / max(total, 1e-9), 1),
        **stats,
    }


def _unsort_rows(blocks: list, inv: torch.Tensor) -> torch.Tensor:
    """Concat a window's sorted embed batches and restore corpus order."""
    return torch.cat(blocks, dim=0)[inv]


def make_encode_fn(retriever):
    """Passage-embed forward over the retriever's live weights:
    ``encode(ids, mask) -> (B, d)``, without autograd."""

    def encode(ids, mask):
        with torch.no_grad():
            return retriever.embed_passages(ids, mask)

    return encode
