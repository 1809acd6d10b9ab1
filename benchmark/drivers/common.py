"""Pieces the drivers share: synchronisation, the CUDA-event span pattern of
``jsa_rag_tpu_torch/analysis/train_step_bench.py`` (copied), the seeded
sample of a window's answers, and the full-size flat index filled with
seeded unit rows through the program's own encoder."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs


def bert_config(config: dict, remat: bool = False, dropout: float = 0.0):
    """The program's tower configuration for a configuration file's
    ``retriever`` group, computing in its ``retriever_compute_dtype``."""
    from jsa_rag_tpu_torch.models.bert import BertConfig

    r = config["retriever"]
    return BertConfig(vocab_size=r["vocab_size"], hidden=r["hidden_size"],
                      layers=r["num_hidden_layers"],
                      heads=r["num_attention_heads"],
                      intermediate=r["intermediate_size"],
                      max_positions=r["max_position_embeddings"],
                      type_vocab=r["type_vocab_size"],
                      ln_eps=r["layer_norm_eps"], pooling=r["pooling"],
                      dtype=getattr(torch, config["retriever_compute_dtype"]),
                      remat=remat, dropout=dropout)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Span:
    """Time between ``start`` and ``stop``: CUDA events on the card (read
    ``ms`` after a synchronise), the host clock on the CPU (copied from
    ``analysis/train_step_bench.py::Span``)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self) -> None:
        self.marks = [self._mark()]

    def stop(self) -> None:
        self.marks.append(self._mark())

    def ms(self) -> float:
        a, b = self.marks
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from
    ``seed`` (Algorithm R): which answers of a window are judged."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def wants(self) -> int | None:
        """The slot the next item would take, or None: ask before making
        the item's copy."""
        self.seen += 1
        if len(self.items) < self.size:
            return len(self.items)
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.size else None

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


def filled_index(index_cfg: dict, seed: int, dev):
    """The configuration's flat index (``rows`` x ``dim`` of ``dtype``),
    every row a seeded unit row written through ``set_embeddings``."""
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex

    n, d = int(index_cfg["rows"]), int(index_cfg["dim"])
    index = ShardedFlatIndex(n, d, index_cfg["dtype"], device=dev)
    for lo, x in inputs.unit_rows(inputs.derive_seed(seed, "rows"), n, d,
                                  dev):
        index.set_embeddings(lo, x)
    return index


def decoded_rows(index, ids) -> torch.Tensor:
    """The rows an int8r flat index holds at ``ids``, decoded from its two
    planes (v1 * s1 + v2 * s2, float32): what the index answers from."""
    i = torch.as_tensor(np.asarray(ids), device=index.embeddings.device,
                        dtype=torch.long)
    v1 = index.embeddings[i].to(torch.float32)
    s1 = index.scales[0, i][:, None]
    if index.res is None:
        return v1 * s1
    v2 = index.res[i].to(torch.float32)
    s2 = index.res_scales[0, i][:, None]
    return v1 * s1 + v2 * s2
