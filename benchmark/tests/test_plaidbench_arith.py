"""The yardstick's arithmetic against hand counts, and the generators
against their seeds and the program's originals."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from plaidbench import corpus, peaks
from plaidbench.profiling import summarize

SCIFACT = json.loads((BENCH / "configs" / "scifact.json").read_text())
LOTTE = json.loads((BENCH / "configs" / "lotte_lifestyle.json").read_text())


def test_maxsim_work_of_a_scifact_pass():
    ops = peaks.maxsim_ops(320 * 32, 1_441_163, 128)
    assert ops == 2 * 320 * 32 * 1_441_163 * 128
    assert round(ops / 1e12, 3) == 3.778
    # PERF.md's bf16 bound of a pass, 3.820 ms, and the int8 cell's 5.1 ms.
    assert round(1e3 * peaks.seconds_at_peak(ops, "bf16"), 3) == 3.820
    lotte = peaks.maxsim_ops(64 * 32, 19_117_356, 128)
    assert round(1e3 * peaks.seconds_at_peak(lotte, "int8"), 1) == 5.1


@pytest.mark.parametrize("cfg,tokens", [(SCIFACT, 1_441_163), (LOTTE, 19_117_356)])
def test_doclens_are_one_multiset_in_a_seeded_order(cfg, tokens):
    a, b, c = (corpus.doclens(cfg, s) for s in (2**31 + 11, 2**31 + 11, 5))
    assert a.sum() == tokens and a.shape == (cfg["documents"],)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c) and np.array_equal(np.sort(a), np.sort(c))


def test_scifact_doclens_are_bench_torchs():
    rng = np.random.default_rng(0)
    orig = np.clip(rng.normal(290, 40, 5183), 64, 300).astype(np.int64)
    assert np.array_equal(np.sort(corpus.doclens(SCIFACT, 1)), np.sort(orig))


def test_lotte_doclens_are_the_megascale_generators():
    orig = np.random.default_rng(1).integers(100, 221, size=119_461)
    assert np.array_equal(np.sort(corpus.doclens(LOTTE, 1)), np.sort(orig))


def test_corpus_and_queries_reproduce_from_the_seed():
    cfg = dict(SCIFACT, documents=40)
    lens = corpus.doclens(cfg, 9)
    t1, top1 = corpus.corpus_device(cfg, lens, 9, torch.device("cpu"))
    t2, top2 = corpus.corpus_device(cfg, lens, 9, torch.device("cpu"))
    t3, _ = corpus.corpus_device(cfg, lens, 10, torch.device("cpu"))
    assert torch.equal(t1, t2) and np.array_equal(top1, top2) and not torch.equal(t1, t3)
    assert torch.allclose(t1.norm(dim=1), torch.ones(t1.shape[0]), atol=1e-5)
    rows = np.array([0, 5, int(lens.sum()) - 1])
    part, _ = corpus.corpus_rows(cfg, lens, 9, torch.device("cpu"), rows)
    assert torch.equal(part, t1[torch.from_numpy(rows)])
    q1, q2 = corpus.queries(cfg, top1, 4, 9), corpus.queries(cfg, top1, 4, 9)
    assert all(np.array_equal(a, b) for a, b in zip(q1, q2))
    assert q1[0].shape == (32, 128) and q1[0].dtype == np.float32


def test_sub_seeds_take_large_seeds():
    assert corpus.sub_seed(2**33 + 5, "x") != corpus.sub_seed(2**33 + 6, "x")
    assert 0 <= corpus.sub_seed(2**40, "corpus") < 2**63


def test_trace_summary_busy_and_gaps():
    events = [("k", 0.0, 1.0), ("k", 0.5, 2.0), ("m", 3.0, 3.5), ("m", 6.0, 6.25)]
    host = [(0.0, 10.0, "outer"), (2.0, 2.9, "bench.result"), (3.6, 5.9, "bench.dispatch")]
    s = summarize(events, host, 10.0)
    assert s["busy_s"] == pytest.approx(2.75)
    assert s["device_ops"][0][0] == "k" and s["device_ops"][0][1] == pytest.approx(2.5)
    assert s["idle_gaps"][0] == ["bench.dispatch", pytest.approx(2.5)]
    assert s["idle_gaps"][1] == ["bench.result", pytest.approx(1.0)]
