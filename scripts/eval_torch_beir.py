"""BEIR retrieval quality of the port: NDCG/MAP/Recall on a BEIR dataset.

Loads a BEIR dataset, indexes it with `nextplaid_tpu_torch`, either in
process or through the port's REST server with server-side encoding, searches
every test query and scores the run with NDCG@10/100, MAP and Recall@10/100.
Counterpart of scripts/eval_beir.py (the JAX package's harness), with the
same flags, output and smoke gate, plus --device.

Modes
  --smoke            a synthetic BEIR dataset and a deterministic hash
                     encoder: no download, no weights. Exits non-zero when
                     NDCG@10 < 0.9 on the planted relevance.
  --data-dir DIR     a BEIR dataset directory (corpus.jsonl, queries.jsonl,
                     qrels/<split>.tsv); needs --model (an HF id in the local
                     cache, or a model directory).
  --mode local|api   local: the encoder, `create_index` and `search_batch`
                     in this process; api (default): `build_app` served on a
                     thread of this process, driven through `NextPlaidClient`.

Everything runs on --device (default cuda, which fails without a card;
--device cpu runs the kernels' plain versions).

Output: one JSON object with the metrics, the throughput and the MaxSim
kernel launches of the run (`kernel_launches`), also written to --out.

Usage:
  python scripts/eval_torch_beir.py --smoke --mode local
  python scripts/eval_torch_beir.py --data-dir DIR --model MODEL_DIR --device cuda
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from nextplaid_tpu_torch.eval import evaluate, load_beir, make_synthetic_beir  # noqa: E402

METRICS = ("map", "ndcg@10", "ndcg@100", "recall@10", "recall@100")
DIM = 128


class _HashEncoderConfig:
    """The config fields the server's /models endpoint reads."""

    model_name = "hash-smoke-encoder"
    embedding_dim = DIM
    query_prefix = ""
    document_prefix = ""
    query_length = 32
    document_length = 64
    do_query_expansion = False
    uses_token_type_ids = False
    mask_token_id = 0
    pad_token_id = 0


class HashEncoder:
    """Deterministic bag-of-token-vectors encoder for smoke runs.

    Each lowercase whitespace token maps to a fixed unit vector drawn from a
    generator seeded by its SHA-256 digest, so a doc holding a query's
    tokens scores ~1.0 per matching query token under MaxSim: planted
    relevance ranks on top with no trained weights. Implements the encoder
    protocol of the server's encode pool (encode_queries, encode_documents,
    config, batch_size, params)."""

    config = _HashEncoderConfig()
    batch_size = 64
    params: Dict = {}

    def _token_vec(self, tok: str) -> np.ndarray:
        h = hashlib.sha256(tok.encode("utf-8")).digest()
        rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
        v = rng.standard_normal(DIM).astype(np.float32)
        return v / np.linalg.norm(v)

    def _encode(self, text: str, max_len: int) -> np.ndarray:
        toks = text.lower().split()[:max_len] or ["<empty>"]
        return np.stack([self._token_vec(t) for t in toks])

    def encode_queries(self, queries) -> List[np.ndarray]:
        return [self._encode(q, self.config.query_length) for q in queries]

    def encode_documents(self, documents, pool_factor: int = 1, **_):
        return [self._encode(d, self.config.document_length) for d in documents]


def load_real_encoder(model: str, quantized: bool = False, device=None):
    """The port's `Colbert` from an HF id in the local cache or a model
    directory, on `device`."""
    from nextplaid_tpu_torch.encoder import Colbert
    from nextplaid_tpu_torch.encoder.hub import resolve_model_dir

    return Colbert(str(resolve_model_dir(model)), quantized=quantized, device=device)


def doc_text(d: Dict[str, str]) -> str:
    return (d["title"] + " " + d["text"]).strip() if d["title"] else d["text"]


def kernel_launches() -> Dict[str, int]:
    """The MaxSim kernels' launches in this process since the last reset."""
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    return {"bf16": mk.maxsim_grid_scores.launches, "int8": mk.maxsim_grid_scores_int8i.launches}


def reset_kernel_launches() -> None:
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    mk.maxsim_grid_scores.launches = 0
    mk.maxsim_grid_scores_int8i.launches = 0


def run_local(documents, queries, qrels, encoder, top_k: int, nbits: int, device=None):
    """In process: encode -> create_index -> load + grid pin ->
    search_batch -> a run dict."""
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index, search_batch,
    )

    t0 = time.perf_counter()
    embs = []
    texts = [doc_text(d) for d in documents]
    bs = encoder.batch_size
    for s in range(0, len(texts), bs):
        embs.extend(encoder.encode_documents(texts[s : s + bs]))
    encode_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="beir_idx_") as tmp:
        idx_dir = os.path.join(tmp, "corpus")
        t0 = time.perf_counter()
        create_index(embs, idx_dir, IndexConfig(nbits=nbits), device=device)
        index = DeviceIndex.load(idx_dir, device=device).with_token_grid()
        index_s = time.perf_counter() - t0

    qids = list(queries)
    q_embs = encoder.encode_queries([queries[q] for q in qids])
    params = SearchParameters(top_k=top_k)
    run: Dict[str, Dict[str, float]] = {}
    t0 = time.perf_counter()
    for s in range(0, len(qids), 64):
        batch = q_embs[s : s + 64]
        for qid, res in zip(qids[s : s + 64], search_batch(index, batch, params)):
            run[qid] = {documents[pid]["id"]: float(sc)
                        for pid, sc in zip(res.passage_ids, res.scores)}
    search_s = time.perf_counter() - t0
    return run, {
        "encode_seconds": round(encode_s, 2),
        "index_seconds": round(index_s, 2),
        "search_seconds": round(search_s, 2),
        "docs_per_second": round(len(documents) / max(encode_s + index_s, 1e-9), 1),
        "qps": round(len(qids) / max(search_s, 1e-9), 1),
    }


def run_api(documents, queries, qrels, encoder, top_k: int, nbits: int,
            url: Optional[str] = None, batch_size: int = 30, device=None):
    """Through the REST service: SDK -> server, server-side encoding. Serves
    `build_app` on a thread of this process when no `url` is given."""
    from nextplaid_tpu_torch.api.inprocess import InProcessServer
    from nextplaid_tpu_torch.client import NextPlaidClient

    server = tmp = None
    if url is None:
        tmp = tempfile.TemporaryDirectory(prefix="beir_srv_")
        server = InProcessServer(tmp.name, encoder, device)
        url = server.url
    try:
        client = NextPlaidClient(url)
        name = "beir_eval"
        if name in client.list_indices():
            client.delete_index(name)
        client.create_index(name, config={"nbits": nbits})

        texts = [doc_text(d) for d in documents]
        meta = [{"doc_id": d["id"]} for d in documents]
        t0 = time.perf_counter()
        client.add(name, texts, metadata=meta, batch_size=batch_size)
        wait_for_count(client, name, len(documents))
        ingest_s = time.perf_counter() - t0

        qids = list(queries)
        run: Dict[str, Dict[str, float]] = {}
        t0 = time.perf_counter()
        for s in range(0, len(qids), 16):
            chunk = qids[s : s + 16]
            resp = client.search(name, queries=[queries[q] for q in chunk], top_k=top_k)
            for qid, res in zip(chunk, resp["results"]):
                run[qid] = {m["doc_id"]: float(sc) for m, sc in zip(res["metadata"], res["scores"])}
        search_s = time.perf_counter() - t0
        return run, {
            "ingest_seconds": round(ingest_s, 2),
            "search_seconds": round(search_s, 2),
            "docs_per_second": round(len(documents) / max(ingest_s, 1e-9), 1),
            "qps": round(len(qids) / max(search_s, 1e-9), 1),
        }
    finally:
        if server is not None:
            server.stop()
            tmp.cleanup()


def wait_for_count(client, name: str, expected: int, timeout: float = 600.0):
    """Adds are applied asynchronously, in batches: poll the index's count."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if client.get_index(name).get("num_documents", 0) >= expected:
            return
        time.sleep(0.3)
    raise TimeoutError(f"index {name} never reached {expected} documents")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", help="BEIR dataset directory")
    ap.add_argument("--split", default="test")
    ap.add_argument("--model", help="HF id (local cache) or encoder directory")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--mode", choices=("local", "api"), default="api")
    ap.add_argument("--url", help="use an already-running server")
    ap.add_argument("--top-k", type=int, default=100)
    ap.add_argument("--nbits", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=30, help="upload batch")
    ap.add_argument("--max-docs", type=int, help="truncate the corpus (debug)")
    ap.add_argument("--max-queries", type=int)
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic dataset + hash encoder; gates NDCG@10 >= 0.9")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which fails without a card)")
    ap.add_argument("--out", help="write the JSON result here too")
    args = ap.parse_args(argv)

    from nextplaid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    reset_kernel_launches()
    with tempfile.TemporaryDirectory(prefix="beir_smoke_") as smoke_dir:
        if args.smoke:
            make_synthetic_beir(smoke_dir, num_docs=64, num_queries=8)
            data_dir, encoder, dataset = smoke_dir, HashEncoder(), "synthetic-smoke"
        else:
            if not args.data_dir:
                ap.error("--data-dir is required (or use --smoke)")
            if not args.model:
                ap.error("--model is required for real datasets (or use --smoke)")
            data_dir = args.data_dir
            encoder = load_real_encoder(args.model, quantized=args.quantized, device=device)
            dataset = os.path.basename(os.path.normpath(data_dir))
        documents, queries, qrels = load_beir(data_dir, split=args.split)

    if args.max_docs:
        keep = {d["id"] for d in documents[: args.max_docs]}
        documents = documents[: args.max_docs]
        qrels = {q: {d: r for d, r in rels.items() if d in keep} for q, rels in qrels.items()}
        qrels = {q: rels for q, rels in qrels.items() if rels}
        queries = {q: t for q, t in queries.items() if q in qrels}
    if args.max_queries:
        qids = list(queries)[: args.max_queries]
        queries = {q: queries[q] for q in qids}
        qrels = {q: qrels[q] for q in qids if q in qrels}

    if args.mode == "local":
        run, timings = run_local(documents, queries, qrels, encoder, args.top_k, args.nbits,
                                 device=device)
    else:
        run, timings = run_api(documents, queries, qrels, encoder, args.top_k, args.nbits,
                               url=args.url, batch_size=args.batch_size, device=device)
    metrics = evaluate(qrels, run, METRICS)

    result = {
        "dataset": dataset,
        "mode": args.mode,
        "device": str(device),
        "num_documents": len(documents),
        "num_queries": len(queries),
        "top_k": args.top_k,
        "nbits": args.nbits,
        "metrics": {k: round(v, 4) for k, v in metrics.items()},
        **timings,
        "kernel_launches": kernel_launches(),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)

    if args.smoke and metrics["ndcg@10"] < 0.9:
        print(f"SMOKE FAILED: ndcg@10 {metrics['ndcg@10']:.4f} < 0.9", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
