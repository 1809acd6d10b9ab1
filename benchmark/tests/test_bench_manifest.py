"""The manifest against its shape rules, the files every cell
finds by name, and which cells report which metrics."""

from __future__ import annotations

import importlib
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(harness.ROOT, MAN["command"][1]))


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_just_their_keys(group):
    for e in MAN[group]:
        extra = set(e) - KEYS[group] - {"workloads"}
        assert not extra and KEYS[group] <= set(e), (e["name"], extra)
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e and group != "end_to_end" and text != "source" \
                    or text == "source" and group == "configs":
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_names_are_unique_and_cells_use_every_config():
    for group in KEYS:
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(w):
    entry, config, traffic, limits = harness.cell_files(MAN, w)
    assert entry["chips"] in (1, 4)
    assert isinstance(config["reduced"], list) and "assumed" in config
    drv = harness.driver(traffic)
    for fn in ("setup", "window", "outputs", "release", "check"):
        assert callable(getattr(drv, fn))
    for m in harness.per_layer_of(MAN, w):
        assert callable(harness.reader(m["name"]))
    for lim in limits.values():
        assert lim["op"] in ("<=", ">=")


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_a_cell_reports_what_its_layers_move(w):
    e2e = {m["name"] for m in harness.end_to_end_of(MAN, w)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_of(MAN, w)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (w, m["name"])


def test_layers_are_named_alike():
    by_name: dict = {}
    for m in MAN["per_layer"]:
        by_name.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_name.values())


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jsa_rag_tpu_torch_probe", object())
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN
        for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jsa_rag_tpu.fake", object())
    assert "jsa_rag_tpu.fake" in harness.forbidden_modules()


def test_nothing_the_benchmark_runs_loads_jax():
    """The harness, every driver, reader, the reference and the program's
    modules they load, in a fresh process: no JAX, jaxlib, flax or JAX
    package module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.controls, benchmark.faults\n"
        "from benchmark import harness\n"
        "man = harness.manifest()\n"
        "for w in man['workloads']:\n"
        "    _, c, t, _ = harness.cell_files(man, w['name'])\n"
        "    harness.driver(t)\n"
        "for m in man['per_layer']: harness.reader(m['name'])\n"
        "import jsa_rag_tpu_torch.train.rag_model, "
        "jsa_rag_tpu_torch.train.step, jsa_rag_tpu_torch.index.build\n"
        "print(harness.forbidden_modules())\n") % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={**os.environ,
                                                      "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            with open(os.path.join(ref, name)) as f:
                text = f.read()
            assert "jsa_rag_tpu" not in text.replace(
                "``jsa_rag_tpu``", "").replace("``jsa_rag_tpu_torch``", ""), \
                name
            assert "import jax" not in text
    importlib.import_module("benchmark.reference.jsa")
