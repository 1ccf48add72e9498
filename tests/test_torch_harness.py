"""The port's harness scripts against their JAX counterparts, on the CPU.

- scripts/eval_torch_beir.py `--smoke` in local and api modes against
  scripts/eval_beir.py run in process on the same seed: NDCG@10 and
  recall@10 within 0.01 (both read 1.0 here, a gap of 0).
- scripts/fetch_torch_eval_assets.py: the mini BEIR fixture it regenerates
  equals the committed bytes, its fixture checkpoint equals the JAX
  script's file for file, and the offline dry run passes its gates
  (NDCG@10 >= 0.85, recall@10 >= 0.95) in both modes.
- scripts/eval_torch_codesearch.py `--smoke` against scripts/eval_codesearch.py
  on the same planted project: equal metrics, NDCG@10 >= 0.9.
- scripts/eval_torch_recall.py on a cut corpus (300 docs, 16 queries): the
  exact bf16 grid's recall@10 against its own f32 oracle is at least 0.99
  (PERF.md section 2's limit, chip_smoke.py's MIN_RECALL; it reads 1.0 here,
  and a bf16 near-tie flipped against the f32 oracle, which the bf16 grid
  does by design, may cost one hit in 160), and every staged point prints
  its line with its launches, warm-up included and timed.
- scripts/run_torch_stress_acceptance.py: the port's `run_cycles` returns the
  JAX package's statistics at the same seed (4 cycles), and the script
  writes only where --out says.
"""

import filecmp
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import eval_torch_beir  # noqa: E402
import eval_torch_codesearch  # noqa: E402
import eval_torch_recall  # noqa: E402
import fetch_torch_eval_assets  # noqa: E402
import run_torch_stress_acceptance  # noqa: E402

GAP = 0.01


def _json_lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _run_jax_script(module, monkeypatch, capsys, *argv):
    """A JAX-side script's main(), which reads sys.argv, in this process."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    assert module.main() == 0
    return _json_lines(capsys)[-1]


@pytest.mark.parametrize("mode", ["local", "api"])
def test_beir_smoke_matches_jax(mode, monkeypatch, capsys):
    import eval_beir

    assert eval_torch_beir.main(["--smoke", "--mode", mode, "--device", "cpu"]) == 0
    ours = _json_lines(capsys)[-1]
    want = _run_jax_script(eval_beir, monkeypatch, capsys, "--smoke", "--mode", mode)
    assert ours["mode"] == mode and ours["device"] == "cpu"
    assert (ours["num_documents"], ours["num_queries"]) == (want["num_documents"],
                                                            want["num_queries"])
    for metric in ("ndcg@10", "recall@10"):
        assert abs(ours["metrics"][metric] - want["metrics"][metric]) <= GAP, (ours, want)
    assert ours["metrics"]["ndcg@10"] >= 0.9
    assert ours["kernel_launches"] == {"bf16": 0, "int8": 0}  # no kernel on the CPU


def test_beir_smoke_gate_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(eval_torch_beir, "evaluate",
                        lambda qrels, run, metrics: {m: 0.5 for m in metrics})
    assert eval_torch_beir.main(["--smoke", "--mode", "local", "--device", "cpu"]) == 1
    assert "SMOKE FAILED" in capsys.readouterr().err


def test_offline_dry_run(tmp_path, capsys):
    import fetch_eval_assets

    gen = tmp_path / "mini_beir"
    fetch_torch_eval_assets.generate_fixture_dataset(gen)
    for rel in ("corpus.jsonl", "queries.jsonl", "qrels/test.tsv"):
        assert (gen / rel).read_bytes() == (fetch_torch_eval_assets.FIXTURE_DIR / rel).read_bytes()
    fetch_torch_eval_assets.write_fixture_checkpoint(tmp_path / "ours")
    fetch_eval_assets.write_fixture_checkpoint(tmp_path / "jax")
    files = ["config.json", "model.safetensors", "1_Dense/model.safetensors",
             "tokenizer.json", "onnx_config.json"]
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "ours", tmp_path / "jax", files,
                                               shallow=False)
    assert (mismatch, errors) == ([], [])

    assert fetch_torch_eval_assets.main(["--offline", "--device", "cpu",
                                         "--out", str(tmp_path / "rec.json")]) == 0
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec == _json_lines(capsys)[-1]
    for mode in ("local", "api"):
        m = rec["results"][mode]["metrics"]
        assert m["ndcg@10"] >= 0.85 and m["recall@10"] >= 0.95, (mode, m)


def test_offline_needs_the_flag():
    with pytest.raises(SystemExit):
        fetch_torch_eval_assets.main(["--device", "cpu"])


def test_codesearch_smoke_matches_jax(monkeypatch, capsys):
    import eval_codesearch

    assert eval_torch_codesearch.main(["--smoke", "--device", "cpu"]) == 0
    ours = _json_lines(capsys)[-1]
    want = _run_jax_script(eval_codesearch, monkeypatch, capsys, "--smoke")
    assert ours["metrics"] == want["metrics"]
    assert (ours["files_indexed"], ours["units_indexed"]) == (want["files_indexed"],
                                                              want["units_indexed"])
    assert ours["metrics"]["ndcg@10"] >= 0.9


def test_recall_sweep_cut_corpus(capsys, monkeypatch):
    monkeypatch.delenv("BENCH_IDX", raising=False)
    assert eval_torch_recall.main(["--device", "cpu", "--docs", "300", "--queries", "16"]) == 0
    lines = _json_lines(capsys)
    assert [ln["config"] for ln in lines] == ["exact bf16 grid (serving default)"] + [
        f"staged nprobe={n}" for n in eval_torch_recall.NPROBES]
    assert lines[0]["recall_at_10"] >= 0.99
    for ln in lines:
        assert 0.0 <= ln["recall_at_10"] <= 1.0 and ln["qps"] > 0
        assert len(ln["qps_passes"]) == 3
        # No kernel on the CPU: the plain versions count no launch.
        assert ln["launches"] == ln["timed_launches"] == {"bf16": 0, "int8": 0}


def test_recall_reuses_bench_idx_of_its_corpus(tmp_path, monkeypatch):
    from nextplaid_tpu_torch.index import IndexConfig, create_index

    import numpy as np

    path = str(tmp_path / "idx")
    create_index([np.eye(4, 128, dtype=np.float32)] * 5, path, IndexConfig(nbits=2),
                 device="cpu")
    monkeypatch.setenv("BENCH_IDX", path)
    with pytest.raises(SystemExit, match="not built from this corpus"):
        eval_torch_recall.main(["--device", "cpu", "--docs", "200", "--queries", "16"])


def test_run_cycles_matches_jax(tmp_path):
    from tests.test_stress_cycles import run_cycles as jax_run_cycles

    ours = run_torch_stress_acceptance.run_cycles(str(tmp_path / "ours"), 4, device="cpu")
    assert ours == jax_run_cycles(str(tmp_path / "jax"), 4)
    assert ours["total_documents_deleted"] > 0


def test_stress_script_writes_only_out(tmp_path, capsys):
    record = os.path.join(ROOT, "docs", "benchmarks", "stress_acceptance.json")
    with open(record, "rb") as f:
        before = f.read()
    with pytest.raises(SystemExit):
        run_torch_stress_acceptance.main(["2", "--device", "cpu", "--out", record])
    out = tmp_path / "stats.json"
    assert run_torch_stress_acceptance.main(["3", "--device", "cpu", "--out", str(out)]) == 0
    stats = json.loads(out.read_text())
    printed = _json_lines(capsys)[-1]
    assert stats == printed and stats["cycles"] == 3 and stats["count_sync_verified_every_op"]
    with open(record, "rb") as f:
        assert f.read() == before
