"""The port's spans (``jsa_rag_tpu_torch/utils/trace.py``) on the CPU: a
shared no-op with no profiler running; under ``torch.profiler`` the train
path's, the int8r search's and the index build's ranges, by name and
nested where they run inside one another. Torch only."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.config import Options
from jsa_rag_tpu_torch.data.passages import PassageStore
from jsa_rag_tpu_torch.index import build_index_for
from jsa_rag_tpu_torch.index.build import build_index, make_encode_fn
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
from jsa_rag_tpu_torch.model_io import load_or_initialize_model
from jsa_rag_tpu_torch.models import bert, lm
from jsa_rag_tpu_torch.train.modes import StepRng
from jsa_rag_tpu_torch.train.optim import set_optim
from jsa_rag_tpu_torch.train.step import make_train_step
from jsa_rag_tpu_torch.utils import trace

TRAIN_SPANS = ("rag.build_batch", "rag.embed_queries", "rag.fetch_ids",
               "rag.union", "rag.tokenize", "jsa.towers", "jsa.generator",
               "jsa.mis", "step.loss", "step.grad", "step.update",
               "dropout.mask", "index.shard_search")
MIPS_SPANS = ("mips.quantize", "mips.scan", "mips.merge", "mips.refine")
BUILD_SPANS = ("build.wait_tokens", "build.h2d", "build.encode",
               "build.write")


def _ranges(prof, tmp_path) -> dict:
    """The profiler's ``record_function`` ranges as its Chrome trace holds
    them: {name: [(start, end)]}."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def _inside(ranges: dict, inner: str, outer: str) -> bool:
    """Every ``inner`` range lies inside an ``outer`` range."""
    return all(any(a <= s and t <= b for a, b in ranges[outer])
               for s, t in ranges[inner])


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def jsa():
    """A tiny jsa model with dropout on, over an int8r flat index of a
    synthetic corpus built by its own passage tower."""
    opt = Options(device="cpu", model_size="tiny", precision="fp32",
                  gold_score_mode="jsa", dropout=0.1, per_gpu_batch_size=2,
                  n_context=3, mis_step=8, temperature_jsa=0.1,
                  text_maxlength=32, target_maxlength=16,
                  index_dtype="int8r", max_vocab=600, lr=1e-3,
                  lr_retriever=1e-3, warmup_steps=1, total_steps=3, seed=0)
    store = PassageStore.synthetic(64)
    model, params, _ = load_or_initialize_model(opt, store)
    index = build_index_for(opt, len(store),
                            model.retriever.cfg.bert.hidden, device="cpu")
    model.build_index(index, params)
    return opt, store, model, params, index


def test_no_profiler_no_span():
    assert not torch.autograd._profiler_enabled()
    first, second = trace.span("rag.build_batch"), trace.span("jsa.mis")
    assert first is second
    with first as got:
        assert got is None
    assert not torch.autograd._profiler_enabled()


def test_a_jsa_step_records_the_train_path(jsa, tmp_path):
    """One ``build_batch`` and one step: every span of the path, the
    generator inside the loss, the masks inside the towers, the search's
    shard scan inside the batch, and one ``dropout.mask`` a draw."""
    opt, _, model, params, index = jsa
    tx = set_optim(opt, params)
    step = make_train_step(model, "jsa", tx)
    rng = StepRng.from_seed(3, "cpu")
    draws = []
    orig = bert.dropout

    def counted(x, rate, seed):
        if seed is not None and rate > 0.0:
            draws.append(seed)
        return orig(x, rate, seed)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bert, "dropout", counted)
        mp.setattr(lm, "dropout", counted)
        with _profiled() as prof:
            batch = model.build_batch(
                "jsa", index, params, ["what is w3", "what is w17"],
                ["w4", "w18"])
            loss, _ = step(params, batch, rng)
    assert torch.isfinite(loss)
    ranges = _ranges(prof, tmp_path)
    missing = [n for n in TRAIN_SPANS + MIPS_SPANS if n not in ranges]
    assert not missing, missing
    assert len(ranges["rag.build_batch"]) == 1
    assert len(ranges["rag.embed_queries"]) == 2  # prior and posterior
    for inner, outer in [("rag.embed_queries", "rag.build_batch"),
                         ("rag.fetch_ids", "rag.build_batch"),
                         ("rag.union", "rag.build_batch"),
                         ("rag.tokenize", "rag.build_batch"),
                         ("index.shard_search", "rag.build_batch"),
                         ("mips.scan", "index.shard_search"),
                         ("jsa.towers", "step.loss"),
                         ("jsa.generator", "step.loss"),
                         ("jsa.mis", "step.loss")]:
        assert _inside(ranges, inner, outer), (inner, outer)
    towers = [r for r in ranges["dropout.mask"]
              if any(a <= r[0] and r[1] <= b for a, b in ranges["jsa.towers"])]
    assert towers
    assert len(draws) > 0
    assert len(ranges["dropout.mask"]) == len(draws)


def test_an_int8r_search_records_its_spans(tmp_path):
    g = torch.Generator().manual_seed(0)
    index = ShardedFlatIndex(512, 32, "int8r", device="cpu")
    index.set_embeddings(0, torch.randn(512, 32, generator=g))
    with _profiled() as prof:
        scores, ids = index.search(torch.randn(4, 32, generator=g), 5)
    assert ids.shape == (4, 5)
    ranges = _ranges(prof, tmp_path)
    for name in ("index.shard_search",) + MIPS_SPANS:
        assert _inside(ranges, name, "index.search"), name
    assert [len(ranges[n]) for n in ("index.search",) + MIPS_SPANS] == \
        [1, 1, 1, 1, 1]


def test_an_index_build_records_its_spans(jsa, tmp_path):
    opt, store, model, params, _ = jsa
    index = ShardedFlatIndex(len(store), model.retriever.cfg.bert.hidden,
                             "int8r", device="cpu")
    tok = model.retriever_tokenizer
    with _profiled() as prof:
        build_index(index, store, make_encode_fn(params["retriever"]), tok,
                    batch_size=8, max_length=32, sort_window=2)
    ranges = _ranges(prof, tmp_path)
    windows = -(-len(store) // 16)
    assert [len(ranges[n]) for n in BUILD_SPANS] == \
        [windows, 2 * windows, 2 * windows, windows]
    # the rows written are the ones an unprofiled build writes
    again = ShardedFlatIndex(len(store), index.dim, "int8r", device="cpu")
    build_index(again, store, make_encode_fn(params["retriever"]), tok,
                batch_size=8, max_length=32, sort_window=2)
    np.testing.assert_array_equal(again.embeddings.numpy(),
                                  index.embeddings.numpy())
