"""Full-stack composite benchmark of nextplaid_tpu_torch: text -> server-side
encoding -> index -> search_with_encoding, one timed pipeline on the card.

The counterpart of scripts/profile_e2e_composite.py. Every reference
baseline includes the encoder (reference README.md:254-267 "indexing docs/s"
runs the ONNX model inside the API;
docs/benchmarks/scifact_docker_benchmark.json:16-32 is server-side encoding
end-to-end: 19.8 docs/s indexing, 55.3 QPS search on CPU; the H100 rows are
41-105 docs/s / 7.9-20.9 QPS). This script is the comparable composite:

  1. Serve `nextplaid_tpu_torch.api.server.build_app` on a thread of this
     process with a real-shape random-weight encoder (answerai-colbert-
     small-v1 geometry: 12 layers, hidden 384, 6 heads, ff 1536, vocab
     30,522 WordPiece, projection 96; weights from seed 0 through
     `encoder.model.init_random_params`).
  2. Upload a SciFact-scale text corpus (default 5,183 docs, ~280 words)
     through POST /indices/{name}/update_with_encoding via the SDK in
     64-doc batches with metadata, 8 uploads at once — the server encodes,
     coalesces, runs the buffer/expand/scratch update triad, writes SQLite
     metadata. Composite indexing docs/s = docs / wall-clock of the upload.
  3. Search 300 excerpt queries through /search_with_encoding, one query
     per request, 16 concurrent workers (the reference README protocol).
     Composite QPS + p50/p95 request latency.
  4. Pipeline equality: the API top-10 of the first 64 queries against the
     same encoder and on-disk index searched in process; overlap >= 0.8.

Usage:
  python scripts/profile_torch_e2e_composite.py            # full (~5183 docs)
  E2E_DOCS=256 python scripts/profile_torch_e2e_composite.py   # smoke
E2E_QUERIES sets the query count, E2E_ENCODE_BATCH the encoder's batch.
Runs on the card ("cuda"); `main(device=)` takes another device. Writes no
file outside a temporary index directory, which it removes. Prints one JSON
line last (bench_torch.py BENCH_E2E=1 consumes it).
"""

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

VOCAB_SIZE = 30_522
N_DOCS = int(os.environ.get("E2E_DOCS", "5183"))
N_QUERIES = int(os.environ.get("E2E_QUERIES", "300"))
DOC_WORDS = 280
QUERY_WORDS = 20
UPLOAD_BATCH = 64
SEARCH_WORKERS = 16
MIN_OVERLAP = 0.8


def make_wordpiece_tokenizer():
    """A real WordPiece tokenizer over a synthetic 30,522-token vocab —
    the tokenizer class and vocab size of the reference models (the cost
    profile of embedding lookup + host tokenization is what matters; the
    strings themselves are synthetic)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.normalizers import Lowercase
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]"]
    n_words = VOCAB_SIZE - len(specials)
    # 4/5 standalone words + 1/5 '##' continuation pieces, like BERT vocab.
    words = [f"w{i:05d}" for i in range(n_words * 4 // 5)]
    words += [f"##s{i:04d}" for i in range(n_words - len(words))]
    vocab = {w: i for i, w in enumerate(specials + words)}
    tok = Tokenizer(WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = Lowercase()
    tok.pre_tokenizer = Whitespace()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    return tok, vocab


def make_encoder(device=None):
    """answerai-colbert-small-v1 geometry, random weights from seed 0 (no
    checkpoint is fetched; activation parity with the JAX encoder is
    tests/test_torch_encoder.py's), on `device` ("cuda" when None)."""
    from nextplaid_tpu_torch.encoder import (
        BackboneConfig,
        Colbert,
        ColbertConfig,
        init_random_params,
    )

    tok, vocab = make_wordpiece_tokenizer()
    bcfg = BackboneConfig(
        model_type="bert", vocab_size=VOCAB_SIZE, hidden_size=384,
        num_hidden_layers=12, num_attention_heads=6, intermediate_size=1536,
        max_position_embeddings=512, projection_dim=96,
    )
    ccfg = ColbertConfig(
        query_prefix="[Q]", document_prefix="[D]", query_length=32,
        document_length=300, embedding_dim=96,
        mask_token_id=vocab["[MASK]"], pad_token_id=vocab["[PAD]"],
    )
    return Colbert(
        config=ccfg, backbone_config=bcfg, tokenizer=tok,
        params=init_random_params(bcfg, seed=0),
        batch_size=int(os.environ.get("E2E_ENCODE_BATCH", "64")),
        device=device,
    ), vocab


def make_text_corpus(vocab, n_docs=N_DOCS, seed=0):
    """Topic-skewed synthetic text: each doc draws from a 600-word topic
    slice plus a common pool (Zipf-ish mixing), so excerpt queries have a
    unique lexical source doc but share vocabulary with distractors."""
    rng = np.random.default_rng(seed)
    words = np.asarray(
        [w for w in vocab if not w.startswith(("[", "##"))], dtype=object
    )
    n_topics = 64
    topic_slices = [
        rng.choice(words, size=600, replace=False) for _ in range(n_topics)
    ]
    common = rng.choice(words, size=2000, replace=False)
    docs = []
    for i in range(n_docs):
        t = topic_slices[i % n_topics]
        own = rng.choice(t, size=DOC_WORDS * 7 // 10)
        mix = rng.choice(common, size=DOC_WORDS - len(own))
        body = np.concatenate([own, mix])
        rng.shuffle(body)
        docs.append(" ".join(body.tolist()))
    return docs


def make_excerpt_queries(docs, n_queries=N_QUERIES, seed=1):
    rng = np.random.default_rng(seed)
    src = rng.choice(len(docs), size=n_queries, replace=False)
    queries = []
    for s in src:
        toks = docs[s].split()
        start = int(rng.integers(0, max(len(toks) - QUERY_WORDS, 1)))
        queries.append(" ".join(toks[start : start + QUERY_WORDS]))
    return queries, src.tolist()


def start_server(indices_dir, encoder, device=None):
    """`build_app(indices_dir, encoder=encoder)` on a thread of this
    process at a free 127.0.0.1 port; returns the running server (`.port`,
    `.stop()`)."""
    from nextplaid_tpu_torch.api.inprocess import InProcessServer

    return InProcessServer(indices_dir, encoder, device)


def main(device=None):
    t_model0 = time.perf_counter()
    encoder, vocab = make_encoder(device)
    docs = make_text_corpus(vocab)
    queries, _ = make_excerpt_queries(docs)
    # Run every encode batch bucket once outside the timed windows: N
    # concurrent single-query requests coalesce into batch sizes 1..N, and
    # a shape's first forward pays one-time costs. Same warming the server
    # does at startup with ENCODE_WARM=1 (EncoderPool.warm).
    encoder.encode_documents(docs[:UPLOAD_BATCH])
    b = 1
    while b <= min(encoder.batch_size, SEARCH_WORKERS * 2):
        encoder.encode_queries(queries[:1] * b)
        b *= 2
    t_warm = time.perf_counter() - t_model0
    print(f"encoder+corpus+warm: {t_warm:.1f}s", flush=True)

    from nextplaid_tpu_torch.client import NextPlaidClient
    from nextplaid_tpu_torch.index import (
        DeviceIndex, SearchParameters, search_batch,
    )

    with tempfile.TemporaryDirectory(prefix="e2e_composite_") as indices_dir:
        server = start_server(indices_dir, encoder, device)
        try:
            c = NextPlaidClient(f"http://127.0.0.1:{server.port}", timeout=600.0)
            if c.health()["status"] not in ("ok", "healthy"):
                raise RuntimeError(f"the server is not healthy: {c.health()}")

            name = "composite"
            metadata = [
                {"doc_id": i, "topic": i % 64, "title": f"synthetic doc {i}"}
                for i in range(len(docs))
            ]

            # ---- composite indexing: text in, searchable index out ----
            # Reference protocol: batches uploaded in parallel
            # (README.md:254-267 "docs uploaded in parallel batches of
            # 64") — concurrency lets the server's ingest worker coalesce
            # up to MAX_BATCH_DOCUMENTS=300 per update cycle.
            def upload(start):
                chunk = docs[start : start + UPLOAD_BATCH]
                meta_chunk = metadata[start : start + UPLOAD_BATCH]
                return c.add(name, chunk, metadata=meta_chunk,
                             batch_size=UPLOAD_BATCH)

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(upload, range(0, len(docs), UPLOAD_BATCH)))
            index_s = time.perf_counter() - t0
            info = c.get_index(name)
            if info["num_documents"] != len(docs):
                raise RuntimeError(f"the index holds {info}, not {len(docs)} docs")
            docs_per_s = len(docs) / index_s
            print(
                f"composite indexing: {len(docs)} docs in {index_s:.1f}s "
                f"= {docs_per_s:.1f} docs/s (encode+index+metadata)",
                flush=True,
            )

            # ---- composite search: text query in, ranked ids out ----
            def one_query(q):
                t0 = time.perf_counter()
                r = c.search(name, [q], top_k=10)
                return time.perf_counter() - t0, r["results"][0]

            with ThreadPoolExecutor(max_workers=SEARCH_WORKERS) as pool:
                # Warm the query-path shapes: concurrent single-query
                # requests coalesce into varying batch sizes server-side,
                # so run three warm rounds before timing.
                for _ in range(3):
                    list(pool.map(one_query, queries[:SEARCH_WORKERS]))
                t0 = time.perf_counter()
                outs = list(pool.map(one_query, queries))
                search_s = time.perf_counter() - t0
            lats = np.asarray(sorted(o[0] for o in outs))
            qps = len(queries) / search_s
            p50 = float(lats[len(lats) // 2]) * 1e3
            p95 = float(lats[int(len(lats) * 0.95)]) * 1e3
            print(
                f"composite search: {len(queries)} q in {search_s:.1f}s = "
                f"{qps:.1f} QPS, p50 {p50:.0f} ms, p95 {p95:.0f} ms",
                flush=True,
            )

            # ---- pipeline-correctness oracle ----
            # Self-retrieval is no correctness signal under random weights
            # (a 12-layer random transformer context-mixes token identity
            # away). The check is pipeline equality: the API result for
            # each text query must match the same encoder + the same
            # on-disk index searched through the library in process.
            oracle_index = DeviceIndex.load(os.path.join(indices_dir, name),
                                            device=encoder.device)
            n_oracle = min(64, len(queries))
            q_embs = encoder.encode_queries(queries[:n_oracle])
            oracle = search_batch(
                oracle_index, q_embs, SearchParameters(top_k=10)
            )
            del oracle_index
        finally:
            server.stop()
    overlaps = []
    for (_, res), o in zip(outs[:n_oracle], oracle):
        got = set(res["document_ids"][:10])
        want = set(o.passage_ids[:10])
        overlaps.append(len(got & want) / max(len(want), 1))
    api_vs_library = float(np.mean(overlaps))
    print(
        f"pipeline equality: API top-10 vs local library top-10 overlap "
        f"{api_vs_library:.3f} over {n_oracle} queries",
        flush=True,
    )
    if not api_vs_library >= MIN_OVERLAP:
        raise AssertionError(
            f"API pipeline diverged from the library oracle: overlap "
            f"{api_vs_library} < {MIN_OVERLAP}"
        )

    payload = {
        "what": "full-stack composite on the card: text -> "
        "server-side encoding (random-weight answerai-colbert-small-shape "
        "torch BERT, WordPiece 30522) -> index build through the API update "
        "path (+SQLite metadata) -> search_with_encoding; SDK over HTTP",
        "protocol": f"{UPLOAD_BATCH}-doc upload batches; "
        f"{SEARCH_WORKERS} concurrent single-query search workers; "
        "composite timings include encoding",
        "n_docs": len(docs),
        "n_queries": len(queries),
        "indexing_docs_per_s": round(docs_per_s, 1),
        "indexing_wall_s": round(index_s, 1),
        "search_qps": round(qps, 1),
        "search_p50_ms": round(p50, 1),
        "search_p95_ms": round(p95, 1),
        "api_vs_library_top10_overlap": round(api_vs_library, 4),
        "correctness_note": "pipeline equality vs in-process library "
        "oracle (same encoder, same on-disk index); self-retrieval is "
        "meaningless under random weights — see scripts/eval_torch_beir.py "
        "for real-weight IR quality",
        "encoder_warm_s": round(t_warm, 1),
        "reference_baselines": {
            "scifact_docker_cpu": {"docs_per_s": 19.8, "qps": 55.3},
            "scifact_h100": {"docs_per_s": 53.1, "gpu_qps": 7.9,
                             "gpu_p95_ms": 169.5},
        },
    }
    print(json.dumps({
        "metric": "e2e_composite",
        "value": round(qps, 2),
        "unit": "qps_with_encoding",
        "vs_baseline": round(qps / 55.3, 2),
        "detail": payload,
    }), flush=True)


if __name__ == "__main__":
    main()
