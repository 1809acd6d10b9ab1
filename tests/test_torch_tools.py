"""The port's end-to-end benches and small tools at tiny sizes on the CPU:
``analysis/{train_step_bench,serve_bench,embed_bench,decode_bench}`` run
end to end with finite times (``serve_bench``'s served ids equal to the
bare search's), ``analysis/coverage`` against the JAX script on one
predictions file, the ``native_store`` CLI against ``NativePassageStore``,
the bulk synthetic corpora, and every new entry point's CUDA default."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.analysis import (coverage, decode_bench, embed_bench,
                                        serve_bench, synthetic,
                                        train_step_bench)
from jsa_rag_tpu_torch.data import native_store
from jsa_rag_tpu_torch.data.passages import PassageStore
from jsa_rag_tpu_torch.demo import (e2e_hard_copy, pretrain_copy_generator,
                                    pretrain_hard_encoder)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _finite_positive(values) -> bool:
    values = list(values)
    return bool(values) and all(math.isfinite(v) and v > 0 for v in values)


def test_train_step_bench_on_the_cpu():
    """Two timed jsa steps after the warm-up at the tiny geometry: every
    part's time finite and positive, the device split summing to the step,
    every loss finite."""
    r = train_step_bench.main(["--size", "tiny", "--n", "2048", "--steps",
                               "2", "--mis", "4", "--n_context", "3",
                               "--text_maxlength", "32", *CPU])
    rows = r["per_step"]
    assert all(len(v) == 2 for v in rows.values())
    assert _finite_positive(v for vs in rows.values() for v in vs)
    for step, grad, update in zip(rows["step_device_ms"],
                                  rows["grad_device_ms"],
                                  rows["update_device_ms"]):
        assert grad + update == pytest.approx(step)
    assert len(r["losses"]) == 2 + train_step_bench.WARMUP
    assert all(math.isfinite(v) for v in r["losses"])
    assert r["storage"] == "float16" and r["examples_per_s"] > 0


@pytest.mark.parametrize("dtype", ["int8r", "float16"])
def test_serve_bench_serves_the_bare_search_ids(dtype):
    """Both settings (the 3 ms window and direct dispatch) at 1 and 3
    clients: one request's passage ids equal ``index.search``'s on the same
    queries, every latency and rate finite and positive."""
    r = serve_bench.main(["--n", "3000", "--d", "32", "--dtype", dtype,
                          "--reqs", "2", "--clients", "1,3", *CPU])
    assert r["served_ids_equal"] == {"3ms": True, "0ms": True}
    assert [(s["window_ms"], s["clients"]) for s in r["settings"]] == [
        (3.0, 1), (3.0, 3), (0.0, 1), (0.0, 3)]
    assert [s["requests"] for s in r["settings"]] == [2, 6, 2, 6]
    assert _finite_positive(v for s in r["settings"]
                            for v in (s["p50_ms"], s["p95_ms"], s["qps"]))
    assert _finite_positive([r["bare_search"]["ms"],
                             r["bare_search"]["ms_max"]])


@pytest.mark.parametrize("rows,k,window_ms,want", [
    (5, 100, 0.0, (5, 100)), (5, 100, 3.0, (8, 128)),
    (9, 13, 3.0, (16, 16)), (32, 64, 3.0, (32, 64))])
def test_dispatch_shape_is_the_batchers(rows, k, window_ms, want):
    """The shape the check searches at: as sent without the batcher, rows
    padded to a power of two (at least 8) and k to a power of two with
    it."""
    assert serve_bench.dispatch_shape(rows, k, window_ms) == want


def test_embed_bench_on_the_cpu():
    """The three default padding policies over 40 wiki-like passages with
    a 2 x 64 encoder: passages/s finite and positive, two builds each."""
    r = embed_bench.main(["--n", "40", "--layers", "2", "--hidden", "64",
                          "--batch", "8", *CPU])
    assert [c["config"] for c in r["configs"]] == [
        "pad512", "bucket-only", "sorted-w8-b64"]
    assert _finite_positive(c["passages_per_s"] for c in r["configs"])
    assert all(len(c["run_seconds"]) == 2 for c in r["configs"])


def test_decode_bench_counts_decode_steps():
    """Greedy and beam at a tiny llama: the full budget runs new - 1 decode
    steps (the first token comes from the prompt's forward); the early-exit
    arm stops sooner; every time finite and positive."""
    r = decode_bench.main(["--layers", "2", "--hidden", "256",
                           "--kv_heads", "1", "--vocab", "512", "--prompt",
                           "16", "--new", "6", "--batches", "2", "--beams",
                           "2", "--iters", "1", *CPU])
    arms = {a["arm"]: a for a in r["arms"]}
    assert set(arms) == {"greedy", "beam2", "greedy-earlyexit"}
    assert _finite_positive(a["ms"] for a in r["arms"])
    assert arms["greedy"]["decode_steps"] == 5
    assert 1 <= arms["beam2"]["decode_steps"] <= 5
    assert arms["greedy-earlyexit"]["decode_steps"] < 5


def _load_script(name: str, *parts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_coverage_matches_the_jax_script(tmp_path, capsys):
    """``analysis.coverage`` prints the numbers of
    ``scripts/analysis/coverage.py`` on one predictions file."""
    rows = [{"passages": [{"text": f"x {i}"} for i in range(60)]
             + [{"text": "the code7 here"}], "answers": ["code7"]},
            {"passages": [{"text": "Code3 is it"}], "answers": ["code3"]},
            {"passages": [{"text": "a"}] * 7 + [{"text": "b q9"}],
             "answers": ["q9", "zz"]},
            {"passages": [], "answers": ["y"]},
            {"passages": [{"text": "no"}] * 30 + [{"title": "t"}],
             "answers": ["yes"]}]
    path = tmp_path / "pred.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    jax_coverage = _load_script("jax_coverage_script", "scripts",
                                "analysis", "coverage.py")
    want = jax_coverage.main(str(path))
    got = coverage.main([str(path)])
    assert got == want and got["n"] == 5
    assert capsys.readouterr().out.splitlines()[-1] == json.dumps(want)


def test_native_store_cli_builds_a_readable_store(tmp_path):
    rows = [{"id": str(i), "title": f"t {i}", "text": f"body ü {i} " * i}
            for i in range(50)]
    src = tmp_path / "corpus.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in rows))
    dst = str(tmp_path / "corpus.bin")
    assert native_store.main([str(src), dst]) == 50
    store = PassageStore(mmap_path=dst)
    assert len(store) == 50
    assert [store[i] for i in (0, 7, 49)] == [rows[i] for i in (0, 7, 49)]


def test_synthetic_passages_are_seeded_and_shaped():
    a, b = (synthetic.uniform_passages(500, seed=3) for _ in range(2))
    assert [a[i] for i in (0, 250, 499)] == [b[i] for i in (0, 250, 499)]
    lens = [len(a[i]["text"].split()) for i in range(500)]
    assert min(lens) >= 8 and max(lens) <= 39
    assert a[7]["id"] == "7" and a[108]["title"] == "title 7"
    w = synthetic.wiki_like_passages(300, seed=1)
    lens = [len(w[i]["text"].split()) for i in range(300)]
    assert min(lens) >= 110 and max(lens) <= 230
    assert 140 < np.mean(lens) < 170
    assert next(iter(w.texts())) == f"t 0 {w[0]['text']}"
    assert synthetic.NumberedPassages(9)[4] == {
        "id": "4", "title": "t4", "text": "passage body 4"}
    with pytest.raises(IndexError):
        a[500]


ENTRY_POINTS = [
    (pretrain_hard_encoder, ["--data", "d", "--out", "o"]),
    (pretrain_copy_generator, ["--data", "d", "--encoder", "e", "--out",
                               "o", "--checkpoint_dir", "c"]),
    (e2e_hard_copy, ["--data", "d", "--out", "o", "--checkpoint_dir", "c"]),
    (train_step_bench, []), (serve_bench, []), (embed_bench, []),
    (decode_bench, []),
]


@pytest.mark.parametrize("module,argv", ENTRY_POINTS,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m, _ in ENTRY_POINTS])
def test_entry_points_default_to_cuda(module, argv):
    """Without ``--device`` each entry point asks for CUDA, and where there
    is none it raises before any work instead of running on the CPU."""
    assert module.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)
