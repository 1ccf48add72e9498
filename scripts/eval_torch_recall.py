"""Recall sweep of the port against the f32 exhaustive oracle.

Builds the SciFact-shape corpus of bench_torch.py (5,183 docs of 64-300
tokens, d 128, made on --device from seed 0; nbits 4), or reuses the index in
$BENCH_IDX built from that corpus, and 128 of its topic-mixture queries.
The oracle is the f32 exhaustive scan at "highest" precision. Then, for
  exact bf16 grid (serving default)   the pinned grid (`with_token_grid()`)
                                      through the bf16 MaxSim kernel,
  staged nprobe=N, N in 1 2 4 8 16    the staged pipeline on the unpinned
                                      index (stage 4 through the same kernel
                                      on a card),
it prints one JSON line: `config`, `recall_at_10` (the last timed pass,
against the oracle), `qps` (the median of 3 timed passes over the
queries in batches of 64, after one warm-up batch), `qps_passes`, the
MaxSim kernels' `launches` in the configuration's run, its warm-up
included, and `timed_launches`, those of the timed passes alone.

    python scripts/eval_torch_recall.py [--device cpu] [--docs N] [--queries N]

Everything runs on --device (default cuda, which fails without a card).
Counterpart of the intent of scripts/eval_recall.py.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from bench_torch import make_corpus_device, make_doclens, make_queries  # noqa: E402
from chip_smoke import recall_at_10  # noqa: E402

BATCH = 64
NPROBES = (1, 2, 4, 8, 16)
PASSES = 3


def sweep(index_f32, queries):
    """The oracle, then each configuration's JSON line on stdout. Returns
    the lines as dicts."""
    from nextplaid_tpu_torch.index import SearchParameters, search_batch
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    oracle = search_batch(index_f32, queries, SearchParameters(
        top_k=10, mode="exact", stage1_precision="highest"))
    index = index_f32.with_token_grid()
    lines = []

    def launches():
        return {"bf16": mk.maxsim_grid_scores.launches,
                "int8": mk.maxsim_grid_scores_int8i.launches}

    def evaluate(label, idx, params):
        mk.maxsim_grid_scores.launches = mk.maxsim_grid_scores_int8i.launches = 0
        search_batch(idx, queries[:BATCH], params)  # warm-up
        warm = launches()
        qps, results = [], []
        for _ in range(PASSES):
            if idx.device.type == "cuda":
                torch.cuda.synchronize(idx.device)
            t0 = time.perf_counter()
            results = []
            for s in range(0, len(queries), BATCH):
                results.extend(search_batch(idx, queries[s : s + BATCH], params))
            qps.append(len(queries) / (time.perf_counter() - t0))
        line = {
            "config": label,
            "recall_at_10": recall_at_10(results, oracle),
            "qps": statistics.median(qps),
            "qps_passes": qps,
            "launches": launches(),
        }
        line["timed_launches"] = {k: n - warm[k] for k, n in line["launches"].items()}
        print(json.dumps(line), flush=True)
        lines.append(line)

    evaluate("exact bf16 grid (serving default)", index,
             SearchParameters(top_k=10, stage1_precision="default"))
    del index
    for nprobe in NPROBES:
        evaluate(f"staged nprobe={nprobe}", index_f32,
                 SearchParameters(top_k=10, mode="staged", n_ivf_probe=nprobe))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which fails without a card)")
    ap.add_argument("--docs", type=int, default=5183, help="corpus size (the docs of $BENCH_IDX)")
    ap.add_argument("--queries", type=int, default=128)
    args = ap.parse_args(argv)

    from nextplaid_tpu_torch.index import DeviceIndex, IndexConfig, create_index_from_device
    from nextplaid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    tokens, topics = make_corpus_device(make_doclens(args.docs), device)
    queries = make_queries(topics, num_queries=args.queries)
    with tempfile.TemporaryDirectory(prefix="eval_idx_") as tmp:
        path = os.environ.get("BENCH_IDX")
        if not (path and os.path.exists(os.path.join(path, "metadata.json"))):
            path = os.path.join(tmp, "corpus")
            create_index_from_device(tokens, make_doclens(args.docs), path,
                                     IndexConfig(nbits=4, seed=42), device=device)
        del tokens
        index_f32 = DeviceIndex.load(path, device=device)
        if index_f32.num_documents != args.docs:
            raise SystemExit(f"{path} holds {index_f32.num_documents} docs, not --docs "
                             f"{args.docs}: it was not built from this corpus")
    sweep(index_f32, queries)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
