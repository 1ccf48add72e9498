"""The controls, on the card, at a size a test run holds: each mix's
`control` in the program's place (a lower-precision pin or the reference
at a lower precision) fails one of the cell's limits that the program, on
the same seeds, keeps. At the cells' own sizes the same readings come from
`benchmark/calibrate.py --control` (PERF.md lists them). Skips without a
card."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch

from conftest import BENCH, tiny_checkout
from plaidbench.registry import Registry

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def _calibrate():
    spec = importlib.util.spec_from_file_location("plaidbench_calibrate", BENCH / "calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_where_the_program_holds(cell, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls are read on the card")
    reg = Registry(tiny_checkout(tmp_path, docs=3000, batch=64))
    mix = reg.mix(reg.cell(cell)["traffic"])
    if mix.get("grid") == "int8":
        monkeypatch.setenv("NEXT_PLAID_PIN_BUDGET_MB", "150")  # bf16 over it, int8 under
    limits = mix["limits"]
    failed_by_control = 0
    for r in _calibrate().readings(reg, [cell], [11, 12, 13], 1.0, True, torch.device("cuda")):
        broken = [k for k, lim in limits.items() if r["numbers"].get(k, float("inf")) > lim]
        if r["side"] == "program":
            assert not broken, r
        else:
            failed_by_control += bool(broken)
    assert failed_by_control == 3
