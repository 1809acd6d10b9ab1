"""Enters the DeepSeek-V2 training cell (``train-jsa-dsv2lite``, driver
``train_jsa_moe``) in the harness's registries that ``test_bench_cells.py``
looks each cell up in, before its cases are collected: ``faults.FAULTS``
(``faults_moe.py``), ``tiny.OVERRIDES`` (``tiny_moe.py``) and
``controls.control_numbers`` (``drivers/train_jsa_moe.py::
control_numbers``). Those files key their entries by driver or by cell;
where they take this cell's entries in, this file goes."""

from benchmark import controls, faults, faults_moe
from benchmark.drivers import train_jsa_moe
from benchmark.tests import tiny, tiny_moe

faults.FAULTS.setdefault("train_jsa_moe",
                         (faults_moe.train_moe, faults_moe.KINDS))
for _w, _ov in tiny_moe.OVERRIDES.items():
    tiny.OVERRIDES.setdefault(_w, _ov)

_control_numbers = controls.control_numbers


def _with_moe(ctx) -> dict:
    if ctx.traffic["driver"] == "train_jsa_moe":
        return train_jsa_moe.control_numbers(ctx)
    return _control_numbers(ctx)


controls.control_numbers = _with_moe
