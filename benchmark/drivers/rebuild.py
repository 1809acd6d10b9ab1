"""An index rebuild: ``index/build.py::build_index`` with
``make_encode_fn(retriever)`` (the passage tower) over a wiki-like corpus,
written into the full-size index at its own rows until the window ends.

``build_index`` embeds the rows of the shard it is given
(``row_offset``, ``local_rows``); the window's rows are handed to it as
such a range of the one index (``IndexRange``), so its tokenising thread,
its length buckets and sort windows, its encode calls and its writes run
as they do in a rebuild, and the writes land in the live index. The first
write past the window's end stops the call (``WindowClosed``).

Traffic parameters: ``batch`` (the embedder batch), ``max_length``,
``length_bucket``, ``sort_window``, ``prefetch``, ``warmup_rows`` (built
in set-up, just before the window's rows), ``span_rows`` (rows a
``build_index`` call is given; the window ends it early),
``sample_rows`` (written rows judged), ``trace_after_s``, ``trace_writes`` (sort
windows a traced run profiles).

End-to-end: ``embed_passages_per_s``, passages embedded and written in the
window over its seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..harness import Window, checks_against
from ..reference import bert as ref_bert
from ..reference import prompts as ref_prompts
from ..reference.precision import Matmul, exact_f32
from ..yardstick import flops
from ..yardstick.trace import Capture, span
from .common import bert_config, decoded_rows, filled_index, sync


class WindowClosed(Exception):
    """Raised from a write once the measured window has closed: it ends the
    ``build_index`` call in flight after the write it made."""


class IndexRange:
    """Rows [start, start + rows) of ``index``, as ``build_index`` takes a
    shard: it embeds ``passages[row_offset:row_offset + local_rows]`` and
    writes them at their own rows through ``set_embeddings``, one sort
    window of rows at a time; ``on_write`` is called after each write."""

    def __init__(self, index, start: int, rows: int, on_write=None):
        self.index = index
        self.device = index.device
        self.row_offset = int(start)
        self.local_rows = int(rows)
        self.on_write = on_write
        self.rows_written = 0

    def set_embeddings(self, start: int, block) -> None:
        self.index.set_embeddings(start, block)
        self.rows_written += int(block.shape[0])
        if self.on_write is not None:
            self.on_write()


def corpus(ctx) -> inputs.WikiPassages:
    c, t = ctx.config, ctx.traffic
    return inputs.WikiPassages(int(c["index"]["rows"]), int(t["words"]),
                               inputs.derive_seed(ctx.seed, "corpus"),
                               t["passage_words"])


def retriever_vocab(t) -> dict:
    return inputs.word_vocab(int(t["words"]), {"[SEP]": inputs.SEP_ID})


def tower(ctx, dev, dtype):
    return inputs.bert_weights(ctx.config["retriever"],
                               inputs.derive_seed(ctx.seed, "tower"), dev,
                               dtype)


def build_tower(ctx, dev):
    """The program's passage tower with the seeded weights."""
    from jsa_rag_tpu_torch.models.bert import BertEncoder

    enc = BertEncoder(bert_config(ctx.config), device=dev)
    dtype = getattr(torch, ctx.config["retriever_param_dtype"])
    enc.load_state_dict(tower(ctx, dev, dtype))
    return enc.to(dtype)


def setup(ctx):
    from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer
    from jsa_rag_tpu_torch.index.build import make_encode_fn
    from jsa_rag_tpu_torch.models.retriever import (DualEncoderRetriever,
                                                    RetrieverConfig)

    t, c, dev = ctx.traffic, ctx.config, ctx.device
    index = filled_index(c["index"], ctx.seed, dev)
    enc = build_tower(ctx, dev)
    retriever = DualEncoderRetriever(
        RetrieverConfig(bert=enc.cfg, tied=False, query_side_only=False),
        towers={"passage": enc, "query": enc})
    tok = SimpleTokenizer(vocab=retriever_vocab(t),
                          max_vocab=int(c["retriever"]["vocab_size"]),
                          frozen=True)
    store = corpus(ctx)
    warm, span_rows = int(t["warmup_rows"]), int(t["span_rows"])
    # the window's first row, drawn from the seed; the warm-up builds the
    # rows just before it, so every length bucket is warm
    first = int(np.random.default_rng(inputs.derive_seed(
        ctx.seed, "start")).integers(warm, len(store) - span_rows))
    state = {"ctx": ctx, "index": index, "store": store, "tok": tok,
             "encode": make_encode_fn(retriever), "first": first,
             "warm": (first - warm, first)}
    build(state, IndexRange(index, first - warm, warm))
    sync(dev)
    return state


def build(state, rows: IndexRange) -> None:
    from jsa_rag_tpu_torch.index.build import build_index

    t = state["ctx"].traffic
    try:
        build_index(rows, state["store"], state["encode"], state["tok"],
                    batch_size=int(t["batch"]),
                    max_length=int(t["max_length"]),
                    passage_fmt="{title} {text}",
                    prefetch=int(t["prefetch"]),
                    length_bucket=int(t["length_bucket"]),
                    sort_window=int(t["sort_window"]))
    except WindowClosed:
        pass


def window(state, seconds: float, trace: bool) -> Window:
    """One ``build_index`` call over the rows from the window's first row
    (another after it, should it end first), ended by the write that
    closes the window: the window runs to the end of that write, every row
    written in it counted."""
    ctx, index = state["ctx"], state["index"]
    t, dev = ctx.traffic, ctx.device
    cap = Capture(dev.type) if trace else None
    mark = {"traced": None, "stopped": False, "writes": 0, "end": None}
    t0 = time.perf_counter()

    def on_write():
        # the host's clock, with no synchronise: the device runs on behind
        # the writes as it does in a rebuild; the device is synchronised
        # only where a trace starts or stops and where the window may have
        # closed, and the window then ends on the clock read after that
        mark["writes"] += 1
        paused = cap.pause_s if cap else 0.0
        elapsed = time.perf_counter() - t0 - paused
        if cap is not None:
            if mark["traced"] is None and \
                    elapsed >= float(t["trace_after_s"]):
                sync(dev)
                cap.start()
                mark["traced"] = mark["writes"]
            elif mark["traced"] is not None and not mark["stopped"] and \
                    mark["writes"] - mark["traced"] >= int(t["trace_writes"]):
                sync(dev)
                cap.stop()
                mark["stopped"] = True
        if elapsed >= seconds and (cap is None or mark["stopped"]):
            sync(dev)
            paused = cap.pause_s if cap else 0.0
            mark["end"] = time.perf_counter() - t0 - paused
            raise WindowClosed

    start, done = state["first"], 0
    while mark["end"] is None:
        rows = IndexRange(index, start + done, int(t["span_rows"]), on_write)
        with span("rebuild.build_index"):
            build(state, rows)
        done += rows.rows_written
    state["written"] = (start, start + done)
    r = ctx.config["retriever"]
    store = state["store"]
    fl = 0.0
    for i in range(start, start + done):
        title, body = store.length(i)
        fl += flops.bert_forward_flops(r, title + body + 2)
    return Window(e2e={"embed_passages_per_s": done / mark["end"]},
                  attempted=done, failed=0, window_s=mark["end"],
                  work={"bf16": fl},
                  trace=cap.trace() if cap else None)


def outputs(state) -> dict:
    """The rows judged, read from the index once the window has closed: a
    seeded sample of the written rows, with the longest passage of the
    first 4,096 among them."""
    ctx = state["ctx"]
    rng = np.random.default_rng(inputs.derive_seed(ctx.seed, "judge"))
    written = np.arange(*state["written"])
    pick = rng.choice(written, size=min(int(ctx.traffic["sample_rows"]),
                                        len(written)), replace=False)
    store = state["store"]
    longest = max(written[:4096], key=lambda i: sum(store.length(i)))
    pick = np.unique(np.append(pick, longest))
    return {"written": pick, "written_rows":
            decoded_rows(state["index"], pick).cpu().numpy()}


def release(state) -> None:
    state.clear()


def check(ctx, outs) -> list:
    return checks_against(ctx.limits, compare(ctx, outs, Matmul("f32")))


def reference_rows(ctx, ids, mm: Matmul) -> torch.Tensor:
    """The passage tower's embeddings of passages ``ids``, by the plain
    reference computed with ``mm``."""
    t, dev = ctx.traffic, ctx.device
    store = corpus(ctx)
    vocab = retriever_vocab(t)
    toks = [ref_prompts.retriever_ids(vocab, ref_prompts.passage_text(
        store[int(i)]), int(t["max_length"])) for i in ids]
    w = tower(ctx, dev, getattr(torch, ctx.config["retriever_param_dtype"]))
    with torch.no_grad():
        return ref_bert.encode_rows(w, ctx.config["retriever"], toks, mm, dev)


def compare(ctx, outs, mm: Matmul) -> dict:
    """``emb_err``: the largest gap between a written row, as the index
    holds it, and the reference's embedding of its passage."""
    exact_f32()
    ref = reference_rows(ctx, outs["written"], mm)
    got = torch.as_tensor(outs["written_rows"], device=ctx.device)
    return {"emb_err": float((got - ref).abs().max())}
