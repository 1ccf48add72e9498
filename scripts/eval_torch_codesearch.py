"""Code-search quality of the port: NDCG@10 over (query -> relevant files).

The bench file is JSONL, one {"query": str, "relevant": [repo-relative
paths]} a line; results are ranked by FILE (the searcher keeps one best hit a
file). Indexing and search go through the port's `ProjectIndexer` and
`Searcher` on --device (default cuda, which fails without a card).
Counterpart of scripts/eval_codesearch.py, with the same flags and output,
plus --device.

Modes
  --smoke           a synthetic project (planted topic functions across many
                    files) and the deterministic hash encoder of
                    scripts/eval_torch_beir.py; exits non-zero when
                    NDCG@10 < 0.9.
  --project DIR --bench FILE --model ID   a real evaluation.

Output: one JSON line {"metrics": {"ndcg@10": ..., "mrr@10": ...,
"recall@10": ..., "map": ...}, ...}, also written to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nextplaid_tpu_torch.eval import evaluate  # noqa: E402

METRICS = ("ndcg@10", "mrr@10", "recall@10", "map")


def load_bench(path: str) -> List[Dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    for r in rows:
        if "query" not in r or "relevant" not in r:
            raise ValueError("bench rows need 'query' and 'relevant' fields")
    return rows


def make_synthetic_project(root: str, num_topics: int = 10, filler: int = 20):
    """Plant one function per topic in its own file + filler files.

    Function names and docstrings carry the topic token, so both the
    semantic (hash-encoder) and keyword (FTS) legs can find them — the same
    planted-relevance trick as eval/beir.make_synthetic_beir.
    """
    os.makedirs(root, exist_ok=True)
    bench = []
    for t in range(num_topics):
        topic = f"quasar{t:03d}"
        fname = f"src/{topic}_service.py"
        os.makedirs(os.path.join(root, "src"), exist_ok=True)
        with open(os.path.join(root, fname), "w") as f:
            f.write(
                f'''"""Service for {topic} processing."""


def handle_{topic}_request(payload):
    """Process a {topic} request and return the {topic} response."""
    result = {{"kind": "{topic}", "payload": payload}}
    return result


def validate_{topic}(value):
    """Check that value is a well-formed {topic} record."""
    return isinstance(value, dict) and value.get("kind") == "{topic}"
'''
            )
        bench.append(
            {"query": f"how do we handle a {topic} request", "relevant": [fname]}
        )
    for i in range(filler):
        fname = f"lib/util_{i:02d}.py"
        os.makedirs(os.path.join(root, "lib"), exist_ok=True)
        with open(os.path.join(root, fname), "w") as f:
            f.write(
                f'''def helper_{i}(x):
    """Generic helper number {i} for shared plumbing."""
    return x * {i + 1}
'''
            )
    return bench


def run_eval(project: str, bench: List[Dict], encoder, top_k: int = 10, device=None):
    from nextplaid_tpu_torch.codesearch.indexer import ProjectIndexer
    from nextplaid_tpu_torch.codesearch.searcher import Searcher, SearchOptions

    with tempfile.TemporaryDirectory(prefix="cseval_idx_") as index_dir:
        t0 = time.perf_counter()
        indexer = ProjectIndexer(project, encoder, index_dir=index_dir, device=device)
        stats = indexer.update()
        index_s = time.perf_counter() - t0

        searcher = Searcher(index_dir, encoder, device=device)
        qrels: Dict[str, Dict[str, int]] = {}
        run: Dict[str, Dict[str, float]] = {}
        t0 = time.perf_counter()
        for i, row in enumerate(bench):
            qid = f"q{i}"
            qrels[qid] = {p: 1 for p in row["relevant"]}
            hits = searcher.search(row["query"], SearchOptions(top_k=top_k))
            run[qid] = {h.file: h.score for h in hits}
        search_s = time.perf_counter() - t0

    metrics = evaluate(qrels, run, METRICS)
    return {
        "num_queries": len(bench),
        "files_indexed": stats.get("changed", 0),
        "units_indexed": stats.get("units", 0),
        "index_seconds": round(index_s, 2),
        "search_seconds": round(search_s, 2),
        "metrics": {k: round(v, 4) for k, v in metrics.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--project", help="repo to index")
    ap.add_argument("--bench", help="JSONL bench file")
    ap.add_argument("--model", help="HF id (local cache) or encoder directory")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which fails without a card)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from eval_torch_beir import HashEncoder, load_real_encoder, kernel_launches, reset_kernel_launches

    from nextplaid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    reset_kernel_launches()
    project = None
    try:
        if args.smoke:
            project = tempfile.mkdtemp(prefix="cseval_proj_")
            bench = make_synthetic_project(project)
            encoder = HashEncoder()
        else:
            if not (args.project and args.bench):
                ap.error("--project and --bench required (or --smoke)")
            if not args.model:
                ap.error("--model required for real evaluation")
            bench = load_bench(args.bench)
            encoder = load_real_encoder(args.model, device=device)
        result = run_eval(project or args.project, bench, encoder, top_k=args.top_k,
                          device=device)
    finally:
        if project is not None:
            shutil.rmtree(project, ignore_errors=True)
    result["device"] = str(device)
    result["kernel_launches"] = kernel_launches()
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if args.smoke and result["metrics"]["ndcg@10"] < 0.9:
        print(f"SMOKE FAILED: ndcg@10 {result['metrics']['ndcg@10']:.4f} < 0.9", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
