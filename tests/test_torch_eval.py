"""The port's retrieval-quality harness (`nextplaid_tpu_torch.eval`): the
reference batteries `tests/test_eval_metrics.py` and
`tests/test_eval_assets_offline.py` loaded by `port_battery` against the
port (the latter's fixture checkpoint through the port's `Colbert`, on the
CPU), the two eval copies equal on random runs and on the files they write
and read, and the harness end to end through the port's server and SDK.

Left out of the batteries: their `slow` runs, which drive the JAX
package's scripts (scripts/eval_beir.py, scripts/eval_codesearch.py,
scripts/fetch_eval_assets.py's dry run).
"""

import os
import sys

import numpy as np
import pytest

from nextplaid_tpu import eval as jax_eval
from nextplaid_tpu_torch import eval as port_eval
from tests.test_torch_api import ServerThread, port_battery

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

_metrics = port_battery("test_eval_metrics")
_assets = port_battery("test_eval_assets_offline",
                       ("enc = Colbert(str(ckpt), batch_size=8)",
                        "enc = Colbert(str(ckpt), batch_size=8, device='cpu')"))
SLOW = ("test_eval_beir_smoke_local", "test_eval_beir_smoke_api", "test_eval_codesearch_smoke")
METRIC_TESTS = tuple(n for n in dir(_metrics) if n.startswith("test_") and n not in SLOW)
for _name in METRIC_TESTS:
    globals()[_name] = getattr(_metrics, _name)
test_fixture_checkpoint_round_trips_hf_names = _assets.test_fixture_checkpoint_round_trips_hf_names


def test_battery_lists_every_reference_test():
    assert len(METRIC_TESTS) == 12
    assert all(hasattr(_metrics, n) for n in SLOW)
    assert {n for n in dir(_assets) if n.startswith("test_")} == {
        "test_offline_dryrun_end_to_end", "test_fixture_checkpoint_round_trips_hf_names"}


def _random_run(seed, n_queries=20, n_docs=50):
    rng = np.random.default_rng(seed)
    qrels = {f"q{q}": {f"d{d}": int(rng.integers(0, 3))
                       for d in rng.choice(n_docs, 6, replace=False)}
             for q in range(n_queries)}
    run = {f"q{q}": {f"d{d}": float(np.round(rng.random(), 2))  # ties on purpose
                     for d in rng.choice(n_docs, 30, replace=False)}
           for q in range(n_queries - 2)}  # two qrels queries missing from the run
    return qrels, run


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_equals_jax(seed):
    qrels, run = _random_run(seed)
    metrics = ("map", "map@5", "ndcg@10", "ndcg@3", "recall@10", "precision@5", "mrr",
               "mrr@3")
    assert port_eval.evaluate(qrels, run, metrics) == jax_eval.evaluate(qrels, run, metrics)


def test_synthetic_beir_and_loader_equal_jax(tmp_path):
    for pkg, name in ((jax_eval, "jax"), (port_eval, "port")):
        pkg.make_synthetic_beir(str(tmp_path / name), num_docs=40, num_queries=6, seed=3)
    for rel in ("corpus.jsonl", "queries.jsonl", os.path.join("qrels", "test.tsv")):
        assert (tmp_path / "jax" / rel).read_bytes() == (tmp_path / "port" / rel).read_bytes()
    assert port_eval.load_beir(str(tmp_path / "port")) == jax_eval.load_beir(str(tmp_path / "jax"))


def test_eval_through_the_port_service(tmp_path):
    """Synthetic BEIR -> the deterministic hash encoder of
    scripts/eval_beir.py on the server -> `add` and `search` through the
    port's SDK -> `evaluate`: planted relevance ranks on top."""
    from eval_beir import HashEncoder

    from nextplaid_tpu_torch.client import NextPlaidClient

    data = str(tmp_path / "beir")
    port_eval.make_synthetic_beir(data, num_docs=64, num_queries=8, seed=0)
    documents, queries, qrels = port_eval.load_beir(data)
    srv = ServerThread(str(tmp_path / "indices"), HashEncoder())
    try:
        client = NextPlaidClient(srv.url)
        client.create_index("beir", config={"nbits": 4})
        client.add("beir", [f"{d['title']} {d['text']}" for d in documents],
                   [{"doc_id": d["id"]} for d in documents], batch_size=32)
        qids = list(queries)
        out = client.search("beir", [queries[q] for q in qids], top_k=10)
    finally:
        srv.stop()
    run = {q: {r["doc_id"]: s for r, s in zip(res["metadata"], res["scores"])}
           for q, res in zip(qids, out["results"])}
    metrics = port_eval.evaluate(qrels, run, ("ndcg@10", "recall@10"))
    assert metrics["ndcg@10"] >= 0.9 and metrics["recall@10"] >= 0.9, metrics
