"""BENCHMARK.json resolves, by name only, to files that exist, keeps to the
contract's shape, and grows by new files and entries alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from plaidbench.registry import NAME_RE, UNIT_RE, Registry

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell, tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(SPEC))
    (tmp_path / "benchmark").symlink_to(BENCH)
    reg = Registry(tmp_path)
    w = reg.cell(cell)
    assert w["chips"] == 1
    assert reg.config(w["config"])["name"] == w["config"]
    mix = reg.mix(w["traffic"])
    assert callable(reg.driver(mix["driver"]).drive)
    e2e = [m["name"] for m in reg.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = reg.per_layer(cell)
    assert layers
    for m in layers:
        assert callable(reg.reader(m["name"]).read)
        assert m["moves"] in e2e
    assert set(mix["limits"]) >= {"missing", "build_mismatches", "codec_quantile_err", "kmeans_excess"}


def test_names_units_and_entries():
    spec = SPEC
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME_RE.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME_RE.match(w["traffic"]) and len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200 and not re.search(r"\s{2}|\t", c["why"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_files_under_paths_are_named_from_name_characters():
    for f in BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_new_cell_mix_driver_and_metric_are_found_without_edits(tmp_path):
    """A later change adds a configuration, a mix, a driver kind and a
    metric as new files and new entries; no existing file changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    (b / "configs" / "nfcorpus.json").write_text(json.dumps(dict(
        json.loads((b / "configs" / "scifact.json").read_text()), name="nfcorpus", documents=3633)))
    (b / "traffic" / "replay_mix.json").write_text(json.dumps({"driver": "replay", "limits": {}}))
    (b / "drivers" / "replay.py").write_text("def drive(run, dep=None):\n    return {'kind': 'replay'}\n")
    (b / "metrics" / "queue_wait_ms.qps.py").write_text("def read(ctx):\n    return ctx.get('wait')\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "nfcorpus", "source": "https://arxiv.org/abs/2104.08663",
                            "file": "benchmark/configs/nfcorpus.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "nfcorpus.replay", "config": "nfcorpus",
                              "traffic": "replay_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "queue_wait_ms.qps", "unit": "ms", "better": "lower",
                              "source": "program_counter", "layer": "search host", "moves": "qps",
                              "workloads": ["nfcorpus.replay"]})
    spec["end_to_end"][0]["workloads"].append("nfcorpus.replay")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path)
    assert reg.config("nfcorpus")["documents"] == 3633
    mix = reg.mix(reg.cell("nfcorpus.replay")["traffic"])
    assert reg.driver(mix["driver"]).drive(None) == {"kind": "replay"}
    layer = [m["name"] for m in reg.per_layer("nfcorpus.replay")]
    assert layer == ["queue_wait_ms.qps"]
    assert reg.reader(layer[0]).read({"wait": 1.5}) == 1.5
    assert {m["name"] for m in reg.end_to_end("nfcorpus.replay")} == {"qps", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scifact.bf16.window2",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, with a
    card faked, the run finds no program and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "sitecustomize.py").write_text(
        "import torch\ntorch.cuda.is_available = lambda: True\ntorch.cuda.device_count = lambda: 1\n")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scifact.bf16.window2",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(fake), "HOME": str(tmp_path)},
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "program" in proc.stderr
