"""One run of one cell: the manifest, the files found by name, the window,
the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``), the one general loop that feeds the program that
kind of traffic from the mix's parameters. The per-layer metrics are read by
``metrics/<name>.py`` each, the limits of the comparisons that decide
``correct`` are ``limits/<workload>.json``. Nothing here branches on a
cell's name.

A driver module has ``setup(ctx) -> state`` (weights, index, warm-up: all
of ``setup_s``), ``window(state, seconds, trace) -> Window``,
``outputs(state) -> dict`` (host copies of what is judged), ``release(state)``
and ``check(ctx, outputs) -> list[Check]`` (the plain reference, run after
the program's state is freed). ``window(state, seconds, trace)`` profiles a
few steady steps when ``trace`` is set.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "jsa_rag_tpu")


@dataclasses.dataclass
class Ctx:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object  # torch.device
    trace: bool


@dataclasses.dataclass
class Window:
    """What a driver's window measured: the end-to-end values by metric
    name, ``attempted``/``failed`` requests, and for the per-layer readers
    (which see the run's ``Ctx`` beside it) the window's seconds, its spans (ms per occurrence, by name), counters,
    the work it asked for (``{"bf16": flops, "int8": ops, "f32": flops,
    "bytes": n}``), and the profiler's ``Trace`` of a few steady steps."""
    e2e: dict
    attempted: int
    failed: int
    window_s: float
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    trace: object = None


@dataclasses.dataclass
class Check:
    """One compared number, its limit and the sense of the limit."""
    name: str
    value: float
    limit: float
    op: str = "<="

    @property
    def ok(self) -> bool:
        if not math.isfinite(self.value):
            return False
        return (self.value <= self.limit if self.op == "<="
                else self.value >= self.limit)


@dataclasses.dataclass
class Record:
    """What a per-layer reader sees."""
    ctx: Ctx
    window: Window


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(man: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic mix, limits) of a cell."""
    w = find(man["workloads"], workload, "workload")
    c = find(man["configs"], w["config"], "config")
    config = load_json(os.path.join(ROOT, c["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
    return w, config, traffic, limits


def driver(traffic: dict):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def end_to_end_of(man: dict, workload: str) -> list[dict]:
    """A cell's end-to-end metrics: those that list it under ``workloads``,
    and those without that key, which every cell reports."""
    return [m for m in man["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_of(man: dict, workload: str) -> list[dict]:
    """A cell's per-layer metrics: each lists its cells under
    ``workloads``."""
    return [m for m in man["per_layer"] if workload in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> float | None``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``jsa_rag_tpu_torch`` is not
    ``jsa_rag_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def checks_against(limits: dict, values: dict) -> list[Check]:
    """The compared numbers, each held to its entry of ``limits``."""
    out = []
    for name, v in values.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        lim = limits[name]
        out.append(Check(name, float(v), float(lim["limit"]),
                         lim.get("op", "<=")))
    return out


def device_of(dev) -> dict:
    import torch

    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def free(dev) -> None:
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def run_cell(man: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, overrides: dict | None = None) -> dict:
    """Run a cell once on ``device`` -> the result dict (the last line).
    ``overrides`` (tests and controls only) replaces parts of the
    configuration, the traffic mix and the limits: ``{"config": {...},
    "traffic": {...}, "limits": {...}}``."""
    import torch

    w, config, traffic, limits = cell_files(man, workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
        limits = {**limits, **overrides.get("limits", {})}
    ctx = Ctx(w, config, traffic, limits, int(seed), device, bool(trace))
    drv = driver(traffic)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = drv.setup(ctx)
    setup_s = time.perf_counter() - t0
    win = drv.window(state, float(seconds), trace)
    dev_info = device_of(device)
    outputs = drv.outputs(state)
    drv.release(state)
    del state
    free(device)
    try:
        checks = drv.check(ctx, outputs)
    except Exception:  # what the run produced could not be judged
        traceback.print_exc()
        checks = [Check("judged", math.inf, 0.0)]
    correct = bool(checks) and all(c.ok for c in checks) and win.failed == 0
    metrics = {}
    if trace:
        rec = Record(ctx, win)
        for m in per_layer_of(man, workload):
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if win.trace is not None:
            dev_info["busy_s"] = win.trace.busy_s()
            dev_info["window_s"] = win.trace.window_s
    else:
        for m in end_to_end_of(man, workload):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            else:
                metrics[m["name"]] = {"value": float(win.e2e[m["name"]]),
                                      "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": dev_info}
    if trace and win.trace is not None:
        result["breakdown"] = {"device_ops": win.trace.device_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "op": c.op, "ok": c.ok} for c in checks}
    return result


def check_lines(result: dict) -> list[str]:
    return [f"check {n}: {c['value']!r} {c['op']} {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAIL'}"
            for n, c in result["checks"].items()]
