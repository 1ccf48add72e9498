"""BEIR-format dataset loading + a synthetic generator for CI smoke runs.

The on-disk layout is the public BEIR standard the reference's harness reads
via `beir.datasets.data_loader.GenericDataLoader`
(benchmark_scifact_docker.py:222-248):

    <data_dir>/
      corpus.jsonl          one JSON object per line: {"_id", "title", "text"}
      queries.jsonl         {"_id", "text"}
      qrels/<split>.tsv     header "query-id\tcorpus-id\tscore", then rows

This loader is written from scratch (it does not need the `beir`
package). `make_synthetic_beir` writes a tiny dataset in the same layout with
known-relevant docs so the full loader -> index -> search -> metrics path
runs in CI with no downloads and no model weights.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

Document = Dict[str, str]  # {"id", "title", "text"}


def load_beir(
    data_dir: str, split: str = "test", require_qrels_queries: bool = True
) -> Tuple[List[Document], Dict[str, str], Dict[str, Dict[str, int]]]:
    """Load a BEIR dataset directory.

    Returns (documents, queries, qrels):
      documents: [{"id", "title", "text"}, ...] in corpus.jsonl order
      queries:   {query_id: text} — restricted to qrels queries when
                 require_qrels_queries (the reference evaluates only those)
      qrels:     {query_id: {doc_id: relevance}}
    """
    corpus_path = os.path.join(data_dir, "corpus.jsonl")
    queries_path = os.path.join(data_dir, "queries.jsonl")
    qrels_path = os.path.join(data_dir, "qrels", f"{split}.tsv")
    for p in (corpus_path, queries_path, qrels_path):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"not a BEIR dataset dir (missing {os.path.relpath(p, data_dir)}): {data_dir}"
            )

    documents: List[Document] = []
    with open(corpus_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            documents.append(
                {
                    "id": str(row["_id"]),
                    "title": str(row.get("title") or ""),
                    "text": str(row.get("text") or ""),
                }
            )

    queries: Dict[str, str] = {}
    with open(queries_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            queries[str(row["_id"])] = str(row.get("text") or "")

    qrels: Dict[str, Dict[str, int]] = {}
    with open(qrels_path, "r", encoding="utf-8") as f:
        header = f.readline()
        # Header row is optional in the wild; detect data-looking first line.
        cols = header.rstrip("\n").split("\t")
        if len(cols) >= 3 and cols[-1].lstrip("-").isdigit():
            _ingest_qrel_row(qrels, cols)
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 3:
                _ingest_qrel_row(qrels, cols)

    if require_qrels_queries:
        queries = {q: t for q, t in queries.items() if q in qrels}
    return documents, queries, qrels


def _ingest_qrel_row(qrels: Dict[str, Dict[str, int]], cols: List[str]) -> None:
    q, d, s = cols[0], cols[1], cols[2]
    qrels.setdefault(str(q), {})[str(d)] = int(s)


def make_synthetic_beir(
    data_dir: str,
    num_docs: int = 64,
    num_queries: int = 8,
    rel_per_query: int = 2,
    split: str = "test",
    seed: int = 0,
) -> None:
    """Write a tiny synthetic BEIR dataset.

    Relevance is planted lexically: each query asks about a unique topic
    token ("topic0007 ...") and its relevant docs contain that token many
    times, so ANY reasonable retriever — including the harness's
    hash-embedding smoke encoder — ranks them on top.
    """
    import random

    rng = random.Random(seed)
    os.makedirs(os.path.join(data_dir, "qrels"), exist_ok=True)
    filler = [
        "system", "index", "vector", "search", "device", "token", "grid",
        "batch", "kernel", "stream", "shard", "merge", "score", "probe",
    ]

    qrels: Dict[str, Dict[str, int]] = {}
    docs: List[Document] = []
    for qi in range(num_queries):
        topic = f"topic{qi:04d}"
        qid = f"q{qi}"
        qrels[qid] = {}
        for r in range(rel_per_query):
            did = f"d{len(docs)}"
            words = [topic] * 6 + rng.sample(filler, 6)
            rng.shuffle(words)
            docs.append(
                {"id": did, "title": f"{topic} notes", "text": " ".join(words)}
            )
            qrels[qid][did] = 1
    while len(docs) < num_docs:
        did = f"d{len(docs)}"
        words = rng.choices(filler, k=12)
        docs.append({"id": did, "title": "misc", "text": " ".join(words)})
    rng.shuffle(docs)

    with open(os.path.join(data_dir, "corpus.jsonl"), "w", encoding="utf-8") as f:
        for d in docs:
            f.write(
                json.dumps({"_id": d["id"], "title": d["title"], "text": d["text"]})
                + "\n"
            )
    with open(os.path.join(data_dir, "queries.jsonl"), "w", encoding="utf-8") as f:
        for qi in range(num_queries):
            f.write(
                json.dumps(
                    {"_id": f"q{qi}", "text": f"tell me about topic{qi:04d}"}
                )
                + "\n"
            )
    with open(
        os.path.join(data_dir, "qrels", f"{split}.tsv"), "w", encoding="utf-8"
    ) as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for qid, rels in qrels.items():
            for did, s in rels.items():
                f.write(f"{qid}\t{did}\t{s}\n")
