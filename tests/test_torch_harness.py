"""The port's harness scripts against their JAX counterparts, on the CPU.

- scripts/eval_torch_beir.py `--smoke` in local and api modes against
  scripts/eval_beir.py run in process on the same seed: NDCG@10 and
  recall@10 within 0.01 (both read 1.0 here, a gap of 0).
- scripts/fetch_torch_eval_assets.py: the mini BEIR fixture it regenerates
  equals the committed bytes, its fixture checkpoint equals the JAX
  script's file for file, and the offline dry run passes its gates
  (NDCG@10 >= 0.85, recall@10 >= 0.95) in both modes. Its online path
  runs against a zip of the mini BEIR fixture served by an `http.server`
  thread on 127.0.0.1 (nothing reaches past the machine): `_download` gives
  the JAX script's outcome, file bytes and exception type on the same URL
  with the right md5, a wrong one and none; `run_online` end to end on the
  CPU with the fixture checkpoint as --model passes the offline gates,
  records the JAX record's provenance keys and sends no request on a second
  run; a --model that is no directory, without `huggingface_hub`, raises a
  message that names it. The JAX `run_online` is not run end to end (its
  scripts/eval_beir.py child reaches the reference encoder's missing
  `import os`): its record's keys come from a run whose child is stood in
  for.
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

import argparse
import filecmp
import hashlib
import http.server
import json
import os
import sys
import threading
import zipfile
from pathlib import Path

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


@pytest.fixture
def loopback(tmp_path, monkeypatch):
    """`mini_beir.zip` (the fixture laid out as BEIR's zips lay a dataset:
    mini_beir/corpus.jsonl, ...) served on 127.0.0.1. Yields (base url, the
    zip's md5, the paths requested so far)."""
    for var in ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY", "HTTPS_PROXY",
                "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    served = tmp_path / "served"
    served.mkdir()
    with zipfile.ZipFile(served / "mini_beir.zip", "w") as z:
        for f in sorted(fetch_torch_eval_assets.FIXTURE_DIR.rglob("*")):
            if f.is_file():
                z.write(f, Path("mini_beir") / f.relative_to(fetch_torch_eval_assets.FIXTURE_DIR))
    requested = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(served), **kw)

        def do_GET(self):
            requested.append(self.path)
            super().do_GET()

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        md5 = hashlib.md5((served / "mini_beir.zip").read_bytes()).hexdigest()
        yield f"http://127.0.0.1:{server.server_address[1]}", md5, requested
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def _download_outcome(download, url, dest, md5):
    try:
        download(url, dest, md5)
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        error = type(e)
    else:
        error = None
    files = {p.name: p.read_bytes() for p in dest.parent.iterdir()}
    return error, files


@pytest.mark.parametrize("case", ["right md5", "wrong md5", "no md5"])
def test_download_matches_jax(case, loopback, tmp_path):
    import fetch_eval_assets

    base, md5, requested = loopback
    want_md5 = {"right md5": md5, "wrong md5": "0" * 32, "no md5": None}[case]
    url = f"{base}/mini_beir.zip"
    outcomes = []
    for name, download in (("ours", fetch_torch_eval_assets._download),
                           ("jax", fetch_eval_assets._download)):
        (tmp_path / name).mkdir()
        outcomes.append(_download_outcome(download, url, tmp_path / name / "mini_beir.zip",
                                          want_md5))
    assert outcomes[0] == outcomes[1]
    error, files = outcomes[0]
    if case == "wrong md5":
        assert error is RuntimeError and files == {}  # no zip, no .part left
    else:
        assert error is None and list(files) == ["mini_beir.zip"]
    assert requested == ["/mini_beir.zip"] * 2


def test_online_run(loopback, tmp_path, monkeypatch, capsys):
    import subprocess

    import fetch_eval_assets

    base, md5, requested = loopback
    monkeypatch.setattr(fetch_torch_eval_assets, "BEIR_BASE", base)
    monkeypatch.setattr(fetch_torch_eval_assets, "DATASET_MD5", {"mini_beir": md5})
    ckpt = fetch_torch_eval_assets.write_fixture_checkpoint(tmp_path / "mini-colbert")
    argv = ["--dataset", "mini_beir", "--model", str(ckpt), "--assets-dir",
            str(tmp_path / "assets"), "--device", "cpu", "--out", str(tmp_path / "rec.json")]
    assert fetch_torch_eval_assets.main(argv) == 0
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec == _json_lines(capsys)[-1]
    m = rec["metrics"]
    assert (rec["mode"], rec["device"], rec["num_documents"]) == ("api", "cpu", 60)
    assert m["ndcg@10"] >= fetch_torch_eval_assets.MIN_NDCG10, m
    assert m["recall@10"] >= fetch_torch_eval_assets.MIN_RECALL10, m
    assert rec["provenance"] == {"dataset_url": f"{base}/mini_beir.zip", "dataset_md5": md5,
                                 "model": str(ckpt), "model_revision": None}
    assert requested == ["/mini_beir.zip"]
    assert (tmp_path / "assets" / "mini_beir" / "corpus.jsonl").is_file()
    # A second run finds the dataset unpacked: no request.
    assert fetch_torch_eval_assets.main(argv) == 0
    assert requested == ["/mini_beir.zip"]

    # The JAX record's provenance keys, its eval child stood in for.
    def child(cmd, check):
        Path(cmd[cmd.index("--out") + 1]).write_text("{}")

    monkeypatch.setattr(subprocess, "run", child)
    monkeypatch.setattr(fetch_eval_assets, "BEIR_BASE", base)
    jax_rec = fetch_eval_assets.run_online(argparse.Namespace(
        dataset="mini_beir", model=str(ckpt), assets_dir=str(tmp_path / "assets")))
    assert rec["provenance"].keys() == jax_rec["provenance"].keys()


def test_online_model_needs_huggingface_hub(tmp_path, monkeypatch):
    import shutil

    shutil.copytree(fetch_torch_eval_assets.FIXTURE_DIR, tmp_path / "assets" / "mini_beir")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # an import of it fails
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        fetch_torch_eval_assets.main(["--dataset", "mini_beir", "--model", "org/not-a-dir",
                                      "--assets-dir", str(tmp_path / "assets"),
                                      "--device", "cpu"])


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
