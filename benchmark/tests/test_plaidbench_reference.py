"""The plain reference against a direct MaxSim and against the program at
a tiny size on the CPU, and the judge against answers with known faults."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from plaidbench import corpus, deploy, judge
from reference import plaid

CPU = torch.device("cpu")
LOTTE = json.loads((BENCH / "configs" / "lotte_lifestyle.json").read_text())
STAGED = {"top_k": 10, "n_ivf_probe": 8, "n_full_scores": 128,
          "centroid_score_threshold": 0.4, "approx_score": "codes"}


@pytest.fixture(scope="module")
def built():
    cfg = dict(LOTTE, documents=1200)
    dep = deploy.build(cfg, 2**32 + 3, CPU)
    yield cfg, dep, plaid.IndexFiles(dep.path, CPU)
    dep.close()


def _direct_maxsim(q: np.ndarray, doc: np.ndarray) -> float:
    return float(sum(max(float(np.dot(t, d)) for d in doc) for t in q))


def test_decompression_equals_the_programs(built):
    from nextplaid_tpu_torch.index import DeviceIndex
    from nextplaid_tpu_torch.index.container import decompress_docs

    _, dep, files = built
    index = DeviceIndex.load(dep.path, device=CPU)
    docs = torch.tensor([0, 7, 1199])
    ours, valid = files.padded_docs(docs)
    mine = files.decompress(ours) * valid[..., None]
    theirs = decompress_docs(index, docs, files.max_len)
    assert torch.allclose(mine, theirs, atol=1e-6)


def test_exact_scores_equal_a_direct_maxsim(built):
    cfg, dep, files = built
    qs = corpus.queries(cfg, dep.topics, 3, 1)
    docs = torch.tensor([3, 400, 1100])
    got = plaid.exact_scores(files, qs, docs=docs)
    for j, d in enumerate(docs.tolist()):
        lo, hi = files.offsets[d], files.offsets[d + 1]
        tok = files.decompress(torch.arange(lo, hi)).numpy()
        for i, q in enumerate(qs):
            assert got[i, j].item() == pytest.approx(_direct_maxsim(q, tok), abs=1e-4)


def test_low_precision_scores_drift_more():
    x = torch.nn.functional.normalize(torch.randn(64, 128), dim=1)
    errs = {}
    for p in ("int8", "int4"):
        v, s = plaid.quantize(x, p)
        errs[p] = (v * s[:, None] - x).abs().mean().item()
        assert torch.all(v == torch.round(v))
    assert errs["int4"] > 10 * errs["int8"] > 0


def test_reference_ivf_equals_the_stored_one(built):
    _, _, files = built
    docs, offsets = files.ivf()
    assert np.array_equal(docs.numpy(), files.stored_ivf)
    assert np.array_equal((offsets[1:] - offsets[:-1]).numpy(), files.stored_ivf_lengths)


def test_staged_reference_gives_the_programs_answers(built):
    """Where pruning changes answers (staged != exact), the reference's pool
    gives the program's staged answers."""
    from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters, search_batch

    cfg, dep, files = built
    qs = corpus.queries(cfg, dep.topics, 24, 4)
    index = DeviceIndex.load(dep.path, device=CPU)
    params = dict(STAGED, exact_max_embeddings=1000)
    staged = search_batch(index, qs, SearchParameters(**params))
    exact = search_batch(index, qs, SearchParameters(top_k=10, mode="exact"))
    assert sum(set(a.passage_ids) != set(b.passage_ids) for a, b in zip(staged, exact)) >= 5
    _, union, scores = plaid.staged_search(files, files.ivf(), qs, STAGED)
    ids, _ = plaid.topk(scores, union, 10)
    assert all(set(ids[i]) == set(r.passage_ids) for i, r in enumerate(staged))
    got = judge.check_staged(files, files.ivf(), [qs], [[(r.passage_ids, r.scores) for r in staged]], STAGED)
    assert got["missing"] == 0 and got["rank_gap_max"] <= 1e-5 and got["score_err_max"] <= 1e-4


def test_judge_sees_altered_missing_and_low_precision_answers(built):
    cfg, dep, files = built
    qs = corpus.queries(cfg, dep.topics, 8, 5)
    scores = plaid.exact_scores(files, qs)
    ids, sc = plaid.topk(scores, torch.arange(files.num_docs), 10)
    good = [(list(ids[i]), list(sc[i])) for i in range(8)]
    sound = judge.check_exact(files, qs, good, 10)
    assert sound["missing"] == 0 and sound["rank_gap_max"] == 0 and sound["score_err_max"] < 1e-6
    swapped = [([(i[0] + 1) % files.num_docs] + i[1:], s) for i, s in good]
    assert judge.check_exact(files, qs, swapped, 10)["rank_gap_max"] > 0.1
    short = [(i[:9], s[:9]) for i, s in good]
    assert judge.check_exact(files, qs, short, 10)["missing"] == 8
    ctl = judge.reference_answers(files, None, [qs], {"top_k": 10}, "int4", staged=False)[0]
    assert judge.check_exact(files, qs, ctl, 10)["score_err_mean"] > 100 * sound["score_err_mean"]
    ok, checks = judge.verdict({"missing": 0.0, "rank_gap_max": 0.5}, {"missing": 0, "rank_gap_max": 0.1})
    assert not ok and checks["rank_gap_max"] == {"value": 0.5, "limit": 0.1}


def test_build_check_finds_a_wrong_code(built):
    cfg, dep, _ = built
    files = plaid.IndexFiles(dep.path, CPU)
    seed = 2**32 + 3
    assert judge.build_check(files, cfg, seed, dep.lens, files.ivf(), CPU)["build_mismatches"] == 0
    files.codes = files.codes.clone()
    files.codes[: judge.BUILD_SAMPLE_TOKENS] = (files.codes[: judge.BUILD_SAMPLE_TOKENS] + 1) % files.centroids.shape[0]
    assert judge.build_check(files, cfg, seed, dep.lens, files.ivf(), CPU)["build_mismatches"] > 0


def test_build_tables_and_centroids_against_their_faults():
    cfg = dict(LOTTE, documents=600, topics=512)  # K 2,048: four cells a topic, as deployed
    seed = 2**32 + 5
    dep = deploy.build(cfg, seed, CPU)
    files = plaid.IndexFiles(dep.path, CPU)
    sound = judge.build_check(files, cfg, seed, dep.lens, files.ivf(), CPU)
    faults = judge.build_faults(files, cfg, seed, dep.lens, CPU)
    assert sound["codec_quantile_err"] < 0.01
    assert faults["codec_quantile_err"] == pytest.approx(0.125, abs=1e-3)
    assert sound["kmeans_excess"] < 0.1 and faults["kmeans_excess"] > 0.3
    dep.close()
