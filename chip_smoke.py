"""Smoke run of nextplaid_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the three CUDA kernel sources (bf16 MaxSim, int8 MaxSim and the
MaxSim variant family, all three instances of the wgmma/TMA template of
csrc/maxsim_wgmma.cuh) from this checkout, one nvcc each, at once, then the
staged route's union grid (csrc/union_grid.cu) and stage-3b scores
(csrc/approx_codes.cu), fails on a
serialized-wgmma warning in the build logs, and holds each MaxSim kernel against
its plain PyTorch version on the card: the edge cases, a main-path slice and
the shapes a 64-row tiling can get wrong (TILING_CASES). Then drives the
port's paths:
  1. the variant sweep of scripts/profile_torch_kernel_variants.py (5,184
     docs x Td 384 x d 128, 64 queries x 32 tokens): every variant checked
     and timed with its launch plan beside the one-big-dot floor and its own
     bound (the valid rows' products for MaxSim, every row's for the probe),
     and the served bf16 kernel timed once at the same shape;
  2. SciFact scale (5,183 docs, doclens 64-300, ~1.5M tokens, d 128,
     nbits 4, 16,384 centroids): a corpus made on the card from a seed,
     `create_index_from_device`, `DeviceIndex.load`,
     `with_token_grid(dtype="bf16")` and `search_batch` over 320 queries,
     with recall@10 against the f32 exhaustive oracle;
  3. the same index pinned as an int8 grid (`with_token_grid("int8")`);
  4. grid-only int8 serving with the exact refinement rerank at the scale
     of scripts/profile_megascale.py (473,000 docs, doclens 100-220,
     ~75.7M tokens, nbits 2, 131,072 centroids): chunks made on the card,
     `create_index_streamed`, `load_grid_only(dtype="int8")` (4 doclen
     buckets, refinement on the device), pipelined `search_batch_async`
     batches of 64 queries, recall@10 refined and unrefined against the f32
     exhaustive scan of `DeviceIndex.load`;
  5. the staged PLAID pipeline on that full index (`mode="staged"`, the
     operating points of scripts/profile_megascale.py and the "quality"
     preset), stage 4's transient union grid built by csrc/union_grid.cu and
     scored by the bf16 MaxSim kernel (one launch of each a batch), stage 3b
     of the "codes" points one launch of csrc/approx_codes.cu a batch: QPS,
     batch-1 latency, recall@10 against the same oracle, a batch's time
     stage by stage, both stage-4 kernels against their plain versions at
     the largest union and the stage-3b kernel at the largest "codes" pool
     ("quality"), with a planted fault it must refuse.
  6. index mutations at SciFact scale, on the index of phase 2 (this slice's
     path): served loads with append headroom (`capacity_factor=1.5,
     grid_aware_capacity=True`) pinned bf16 and int8, ingest batches of 32
     docs through `update_or_create_with_metadata` (buffer mode) and
     `DeviceIndex.append_batch`, each checked against a fresh reload + pin;
     a capacity growth (`_grow`); a centroid expansion (mode "expand");
     FIFO eviction of the 100 oldest docs with `delete_with_options` (the
     metadata store and FTS kept in sync); and the stale-IVF reroute of a
     staged request, then `refresh_ivf` and staged recall.
  7. text to a searchable index, after the mutations and before the
     megascale build: first `ops.attention.varlen_attention`'s kernel
     against its plain version on one packed forward at the rerank cells'
     shapes (32 log-normal document lengths and one of 8,192; 12 x 64
     heads, a global and a local layer with RoPE, and jina-colbert-v2's
     global layer at 16 x 64 heads, theta 20,000), at a bound that each
     layer kind's planted fault (a skipped key tile, a narrower band) must
     fail; then
     the ColBERT encoder at GTE-ModernColBERT-v1's widths (22 layers,
     hidden 768, random weights from seed 0, bf16), its packed forward held
     against the f32 padded forward (the JAX chain) on the CPU, and its
     quantized forward against full precision, each forward's attention
     one launch of the kernel a layer; 5,183 documents of
     280 words, from a whitespace tokenizer over a synthetic 50,368-word
     vocabulary, through `encode_documents`;
     `create_index_streamed` (nbits 4) in chunks of 1,024 docs, interrupted
     at chunk 3 and resumed byte-equal to an uninterrupted build; load +
     bf16 pin; 320 encoded excerpt queries through `search_batch`, recall@10
     against the f32 oracle; the BERT family's throughput at
     answerai-colbert-small's widths; then jina-colbert-v2 at its published
     widths (24 rotary post-LN layers, hidden 1,024) from a model directory
     by Jina's flash names through `Colbert(model_dir=...)`: one rerank
     request's documents in packed forwards, its attention launches (set to
     0 just before) one a layer of each forward and equal to the traced
     `encode.attn_layers_global`, every pair global, against the plain f32
     reference (tests/jina_colbert_reference.py) on the card.
  8. the REST service (this slice's path), after the encoder phase: the
     SciFact index as built (a copy kept before the mutations) with the
     server's config.json and metadata + FTS on every doc, the encoder at
     GTE-ModernColBERT-v1's widths, `nextplaid_tpu_torch.api.server.build_app`
     on a thread of this process, driven over HTTP by the port's SDK:
     64-query base64 requests from 8 clients, single-query requests from 16
     (coalesced), filtered and hybrid searches, text queries, /encode and
     /rerank_with_encoding, three ingest batches appended in place into the
     served grid (its data_ptr unchanged) and /update_with_encoding,
     serve_mode grid_only (the int8 kernel) on a copy; every answer held
     against the same call in process; one request split by stage (the
     parse, search_batch, the metadata attach, JSON both ways, against the
     same request over HTTP); then the server as a subprocess
     (`python -m nextplaid_tpu_torch.api.server --device cuda`), which must
     answer and exit 0 within 10 s of SIGTERM.
  9. the RQ (residual-quantized) codebook, after the service: the first
     110,000 docs of the megascale corpus (~17.6M tokens, nbits 2), where
     the K heuristic gives RQ_MIN_K = 65,536 = 256 x 256;
     `create_index_streamed(centroid_structure="rq")` (train, assign and the
     rest timed apart), `DeviceIndex.load`, staged search at the operating
     points of phase 5 and "quality" with stages 1-2 over the factored
     codebook and stage 4 through the union grid and bf16 kernels (each
     held against its plain version at the largest union), against the flat
     control (the same index with its rq_* fields None) and the f32
     exhaustive oracle; then the stage-3b kernel on the flat control at the
     LoTTE staged cell's operating point (K 65,536, pool 4,096).
  10. code search (`cgrep`, this slice's path): `ProjectIndexer` over a copy
     of this checkout's files with the encoder at GTE-ModernColBERT-v1's
     widths (random weights from seed 0, a character-fallback WordPiece made
     with `tokenizers`), an incremental update of one edited file,
     `Searcher.search` for 50 queries from the tree's own names and
     docstrings with and without path, glob and regex filters, the card's
     hits against a CPU search of the same index and query embeddings, and
     `python -m nextplaid_tpu_torch.codesearch.cli --device cuda --json`
     over a model directory of the same weights.
  11. doc-range sharding (`nextplaid_tpu_torch.parallel`, this slice's
     path), after the encoder phase and before the service: the SciFact
     index over an in-process mesh of 4 shards on the one card, (a)
     `ShardedGridIndex.shard_grid_only` bf16 and int8 and
     `search_batch_sharded_grid` (both kernels, one launch a shard, one
     shard's output held against the plain version) against the
     single-card pinned grid; (b) `ShardedIndex.shard(capacity_factor=1.5)`:
     exact against the single-card scan, staged recall at the default and
     "quality" points against the single card's, one 32-doc batch appended
     in place to it (then `refresh_ivf`) and to both grids, each against a
     fresh shard of the updated index; (c) `lloyd_sharded` against `lloyd`
     on the build's k-means sample at K 16,384; (e) the bf16 grid over two
     processes x 2 shards on the card (gloo, the ranks sharing the card)
     and one process x 4 shards (NCCL), joined by `init_distributed` from
     the NEXT_PLAID_* variables (this script run as
     `chip_smoke.py --rank ...`); (f) `build_app` serving "sharded" and
     "sharded_grid" (one shard a visible card), HTTP top-10 against the same
     search in process and a /documents batch appended in place (no
     reload). Its (d) runs after phase 5: the megascale index as 4 int8 grid
     shards, unrefined top-10 against phase 4's, recall@10.
  12. the entry points outside the package (the eleventh slice's path):
     `nextplaid_tpu_torch.entry.entry()`'s staged step against
     `search_batch` (a), `dryrun_multichip(4)` on 4 shards of the card
     ending in its `DRYRUN VERIFIED:` line (b), then the scripts as a user
     runs them, each a child process with --device cuda whose JSON is read:
     scripts/eval_torch_recall.py on phase 2's index (c, exact bf16 recall@10
     >= 0.99), and at once scripts/eval_torch_beir.py --smoke in local and
     api modes and scripts/fetch_torch_eval_assets.py --offline (d, their
     gates), scripts/eval_torch_codesearch.py --smoke (e) and
     scripts/run_torch_stress_acceptance.py 12 (f). The children print their
     kernel launches, which the kernels line adds. Each kernel is held
     against its plain version at the arguments (a)-(d) give it.
  13. the online eval-asset fetch (this slice's path), after the harness:
     a zip of tests/fixtures/mini_beir served by an `http.server` thread on
     127.0.0.1, scripts/fetch_torch_eval_assets.py run online twice with
     --device cuda into a fresh --assets-dir (its BEIR_BASE and DATASET_MD5
     pointed at the loopback server in its process): the zip arrives once,
     md5 checked, the second run requests nothing, a wrong md5 raises and
     leaves no file, and each run passes the offline dry run's gates.
  14. the CUDA image replayed on the card (the twelfth slice's path):
     without docker, a directory holding only docker/Dockerfile.cuda's COPY
     set stands for /app; its build step (the served kernels: both MaxSim
     kernels, the union grid and stage 3b, and the native host library) and import
     check run there; then the server
     starts from the image's ENTRYPOINT and docker-compose.yml's command
     and environment (docker-compose.cuda.yml laid over it; the volumes
     mapped to the SciFact index and a model directory at
     GTE-ModernColBERT-v1's widths), (a) with the compose defaults (the
     bf16 kernel) and (b) with NEXT_PLAID_SERVE_MODE=grid_only (the int8
     kernel), each driven over HTTP through the SDK and held against
     in-process search; the servers compile nothing and load the copy's
     libraries.
  15. the headline benchmark as a user runs it (this slice's path), last:
     bench_torch.py from the root of this checkout, each step a process of
     its own: (a) at SciFact scale with a fresh BENCH_IDX, three fresh
     children (child 1 builds the index, children 2-3 reload it), each a
     warm-up and 12 pipelined `search_batch_async` passes of 320 queries at
     windows 2 and 6 through the bf16 kernel, recall@10 against the f32
     oracle; (b) BENCH_PIN_DTYPE=int8 over the same index (the int8
     kernel); (c) BENCH_E2E=1, scripts/profile_torch_e2e_composite.py at
     5,183 texts and 300 queries (server-side encoding, ingest and search
     over HTTP, API top-10 against the library's). A sitecustomize.py has
     each of their processes write its launches and peak allocated memory
     at exit.
  Phases 9 and 10 run after phase 8 and before phases 4-5 (grid-only and
  staged serving at megascale), whose build needs the most memory.
The megascale path also loads its host arrays twice with the merge cache
forced on (a native merge that stores the cache, then a hit), both held
against numpy's concatenation; the native host library is built from
native/nextplaid_host.cpp with g++ at the start.
Each path's kernel launch counts are set to 0 just before it and read just
after.

Prints one line per phase, then a {"kernels": [...]} JSON line, and as its
last line {"ok": true, "device": {...}}. Exits non-zero, with no result,
when CUDA is unavailable or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# The SciFact-shape corpus and the card's dense peaks: bench_torch.py's.
from bench_torch import (
    PEAK_BF16_FLOPS,
    PEAK_INT8_OPS,
    make_corpus_device,
    make_doclens,
    make_queries,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published HBM3 rate.
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version: both sum exact products in f32, in other orders;
# allowed |difference| is this fraction of the largest |score|.
KERNEL_RTOL = 1e-4
MIN_RECALL = 0.99
MIN_RECALL_INT8 = 0.95  # unrefined int8 grids lose a little recall by design
NUM_QUERIES = 320
TIMED_PASSES = 10

# Grid-only main path: the corpus of scripts/profile_megascale.py.
MEGA_DOCS = 473_000
MEGA_LEN = (100, 220)
MEGA_TOPICS = 16384
MEGA_CHUNK_DOCS = 16_000
MEGA_SAMPLE_TOKENS = 1 << 21
MEGA_BATCH = 64
MEGA_IN_FLIGHT = 6
MEGA_PASSES = 5

# Staged path: scripts/profile_megascale.py's operating points, each with the
# JAX package's own recorded recall@10 (docs/benchmarks/megascale_tpu.json,
# a property of the algorithm, not of the TPU); the port must reach it less
# RECALL_SLACK. The "quality" preset must reach MIN_RECALL_QUALITY.
STAGED_POINTS = (
    ("cells nprobe 8 keep 256", dict(approx_score="cells", n_ivf_probe=8, prune_keep=256), 0.9203),
    ("cells nprobe 8 keep 1024", dict(approx_score="cells", n_ivf_probe=8, prune_keep=1024), 0.9750),
    ("codes nprobe 8 keep 256", dict(approx_score="codes", n_ivf_probe=8, prune_keep=256), 0.9688),
    ("cells nprobe 16 keep 1024", dict(approx_score="cells", n_ivf_probe=16, prune_keep=1024), 0.9906),
)
STAGED_COMMON = dict(top_k=10, mode="staged", overflow_policy="prune", stage1_precision="default")
RECALL_SLACK = 0.03
MIN_RECALL_QUALITY = 0.97
STAGED_PASSES = 3
# Kernel route vs scan route of stage 4: both score bf16-rounded tokens and
# queries with f32 sums; the tie rule's tolerance is the bf16 one.
STAGE4_TOL = 2e-2
# The probe's sums hold ~1e6 products each, summed in other orders.
PROBE_RTOL = 1e-3

# Mutation phase: the API's serving headroom (nextplaid_tpu/api/state.py:117),
# ingest batches of 32 docs (three fill the buffer to 96 < buffer_size 100),
# FIFO eviction of the 100 oldest docs.
MUT_CAPACITY = 1.5
MUT_BATCH = 32
MUT_BUFFERED_BATCHES = 3
MUT_EVICT = 100
# Appended index vs a fresh reload: the same rows decompressed from the same
# codes, scored by the same kernel; scores within this fraction of the largest.
MUT_RTOL = 1e-4


def time_ms(fn, reps):
    """Mean device time of `fn` in ms over `reps` runs, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def maxsim_bound(qflat, grid, doclens, tq):
    """Least time (ms) of one MaxSim call on these inputs: products needed by
    the docs' real tokens at the bf16 peak vs each input read once and the
    output written once at the HBM rate. Returns (ms, bound_by, dense_ms),
    dense_ms counting every grid row slot."""
    qf, d = qflat.shape
    nd, td, _ = grid.shape
    tokens = int(torch.clamp(doclens, max=td).sum())
    ops = 2.0 * qf * d * tokens
    nbytes = qf * d * 2 + nd * td * d * 2 + nd * 4 + (qf // tq) * nd * 4
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    dense_ms = 1e3 * 2.0 * qf * d * nd * td / PEAK_BF16_FLOPS
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), dense_ms


def maxsim_bound_int8(qi8, grids, scales, q_n):
    """Least time (ms) of one int8 MaxSim pass over `grids` (one call per
    grid): the int8 products of the docs' valid tokens (positive scale) at
    the int8 peak vs each input read once and each output written once at
    the HBM rate. Returns (ms, bound_by)."""
    qf, d = qi8.shape
    tokens = sum(int((s.float() > 0).sum()) for s in scales)
    ops = 2.0 * qf * d * tokens
    nbytes = len(grids) * qf * (d + 4) + sum(
        g.numel() + s.numel() * 2 + q_n * g.shape[0] * 4 for g, s in zip(grids, scales)
    )
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tile_waste(lens):
    """Share of the rows a 64-row tiling multiplies that lie at or past the
    docs' lengths (`lens`: a tensor or array of row bounds, one a doc)."""
    lens = torch.as_tensor(lens).to(torch.int64)
    walked = int(((lens + 63) // 64 * 64).sum())
    return 1.0 - int(lens.sum()) / max(walked, 1)


def int8_row_bounds(scales):
    """1 + the last token with a positive scale, per doc: where the int8
    kernel stops walking a doc."""
    valid = scales.float() > 0
    idx = torch.arange(1, scales.shape[1] + 1, device=scales.device)
    return (valid * idx).amax(dim=1)


def check_kernel(kernel, plain, args, label):
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    got = kernel(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(
            f"{label}: kernel output {tuple(got.shape)} is not finite or not "
            f"shaped as {tuple(want.shape)}"
        )
    err = float((got - want).abs().max())
    tol = KERNEL_RTOL * max(float(want.abs().max()), 1.0)
    print(f"kernel check [{label}]: max|kernel - plain| = {err:.3e} (tolerance {tol:.3e}, "
          f"max|score| {float(want.abs().max()):.3f})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{label}: kernel disagrees with its plain version: {err} > {tol}")
    return err


def edge_case_inputs(device):
    """Ragged Td (40), zero-length docs, padded query tokens, and a doc
    whose similarities to query 0 are all negative."""
    rng = np.random.default_rng(3)
    q_n, tq, nd, td, d = 5, 32, 77, 40, 128
    q = rng.standard_normal((q_n, tq, d)).astype(np.float32)
    q[:, 27:] = 0.0
    q[0] = np.abs(q[0])
    grid = rng.standard_normal((nd, td, d)).astype(np.float32)
    lens = rng.integers(1, td + 1, nd).astype(np.int32)
    lens[[2, 40, nd - 1]] = 0
    lens[1] = 5
    grid[1] = -np.abs(grid[1])
    for i in range(nd):
        grid[i, lens[i]:] = 0.0
    to = lambda x, dt: torch.from_numpy(x).to(device, dt)
    q = q.reshape(q_n * tq, d)
    return to(q, torch.bfloat16), to(grid, torch.bfloat16), to(lens, torch.int32), tq


def slice_inputs(device):
    """A main-path-shaped slice: 64 queries x 32 tokens against 512 grid rows
    x Td 304 x 128 with SciFact doclens."""
    rng = np.random.default_rng(4)
    lens = make_doclens(512, seed=5).astype(np.int32)
    q = rng.standard_normal((64 * 32, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    grid = rng.standard_normal((512, 304, 128)).astype(np.float32) / np.sqrt(128)
    for i in range(512):
        grid[i, lens[i]:] = 0.0
    to = lambda x, dt: torch.from_numpy(x).to(device, dt)
    return to(q, torch.bfloat16), to(grid, torch.bfloat16), to(lens, torch.int32), 32


def int8_edge_inputs(device):
    """Td 64 with ragged valid lengths, docs with no valid token,
    zero-scale (padded) query tokens, a doc whose dots with query 0 are all
    negative, and a real all-zero token (scale 1.0, valid)."""
    rng = np.random.default_rng(6)
    q_n, tq, nd, td, d = 5, 32, 300, 64, 128
    q = rng.integers(-127, 128, (q_n, tq, d)).astype(np.int8)
    qs = rng.uniform(0.002, 0.01, (q_n, tq)).astype(np.float32)
    q[:, 27:] = 0
    qs[:, 27:] = 0.0
    q[0] = np.abs(q[0].astype(np.int16)).clip(0, 127).astype(np.int8)
    grid = rng.integers(-127, 128, (nd, td, d)).astype(np.int8)
    sc = rng.uniform(0.002, 0.01, (nd, td)).astype(np.float32)
    lens = rng.integers(1, td + 1, nd)
    lens[[2, 40, nd - 1]] = 0
    lens[1] = 5
    grid[1] = -np.abs(grid[1].astype(np.int16)).clip(0, 127).astype(np.int8)
    for i in range(nd):
        grid[i, lens[i]:] = 0
        sc[i, lens[i]:] = 0.0
    grid[5, 0] = 0
    sc[5, 0] = 1.0
    return (torch.from_numpy(q.reshape(q_n * tq, d)).to(device),
            torch.from_numpy(qs.reshape(-1)).to(device),
            torch.from_numpy(grid).to(device),
            torch.from_numpy(sc).to(device, torch.bfloat16), tq)


def int8_slice_inputs(device):
    """A main-path-shaped slice: 64 queries x 32 tokens against 512 rows x
    Td 224 x 128 of quantized unit tokens with doclens 100-220."""
    from nextplaid_tpu_torch.index.container import quantize_tokens_int8
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8

    gen = torch.Generator(device=device).manual_seed(7)
    q = torch.randn(64 * 32, 128, generator=gen, device=device)
    qi8, qs = quantize_queries_int8(q / q.norm(dim=1, keepdim=True))
    emb = torch.randn(512, 224, 128, generator=gen, device=device)
    lens = torch.randint(100, 221, (512,), generator=gen, device=device)
    valid = torch.arange(224, device=device)[None, :] < lens[:, None]
    emb = torch.where(valid[:, :, None], emb / emb.norm(dim=2, keepdim=True), 0.0)
    grid, scales = quantize_tokens_int8(emb, valid)
    return qi8, qs, grid, scales, 32


# Shapes the served kernels' 64-row tiling can get wrong, as
# (label, q_n, tq, nd, td, d, lens): lens is a list of doc lengths (cycled
# over nd, the last doc always full) or None for random lengths. Both types.
TILING_CASES = (
    ("lens 63/64/65/128/Td, Td 200, nd 13", 3, 32, 13, 200, 128, [63, 64, 65, 128, 200, 0, 1, 199, 129, 127]),
    ("nd 1, one query", 1, 32, 1, 72, 128, [72]),
    ("nd 1 empty", 2, 32, 1, 64, 128, [0]),
    ("8 columns", 1, 8, 37, 96, 128, None),
    ("16 columns", 1, 16, 37, 96, 128, None),
    ("24 columns", 1, 24, 37, 96, 128, None),
    ("40 columns", 1, 40, 37, 96, 128, None),
    ("544 columns (above 512), nd 70", 17, 32, 70, 136, 128, None),
    ("odd query groups: 24 queries", 24, 32, 33, 304, 128, None),
    ("tq 200: one query a warpgroup", 3, 200, 19, 100, 128, None),
    ("tq 48: queries do not fill N", 11, 48, 21, 80, 128, None),
    ("d 64", 5, 32, 29, 130, 64, None),
    ("d 48 (padded)", 5, 32, 29, 70, 48, None),
    ("d 256", 9, 32, 29, 130, 256, None),
    ("d 256, tq 130", 2, 130, 9, 66, 256, None),
)


def tiling_case_arrays(case, seed=11):
    """numpy inputs of one TILING_CASES entry: queries [q_n*tq, d] f32 (the
    last 3 tokens of each query zero: padding), grid [nd, td, d] f32 (zero
    at and past each doc's length), lens [nd] int32."""
    _, q_n, tq, nd, td, d, lens = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((q_n, tq, d)).astype(np.float32)
    q[:, max(tq - 3, 1):] = 0.0
    grid = rng.standard_normal((nd, td, d)).astype(np.float32)
    if lens is None:
        lens = rng.integers(0, td + 1, nd)
    lens = np.resize(np.asarray(lens), nd).astype(np.int32)
    lens[-1] = td if nd > 1 or lens[-1] > 0 else 0  # the grid's last doc is full
    for i in range(nd):
        grid[i, lens[i]:] = 0.0
    return q.reshape(q_n * tq, d), grid, lens


def tiling_case_bf16(case, device):
    """Arguments of `maxsim_grid_scores` for one tiling case."""
    q, grid, lens = tiling_case_arrays(case)
    to = lambda x, dt: torch.from_numpy(x).to(device, dt)
    return to(q, torch.bfloat16), to(grid, torch.bfloat16), to(lens, torch.int32), case[2]


def tiling_case_int8(case, device):
    """Arguments of `maxsim_grid_scores_int8i` for one tiling case: int8
    values, positive scales below each doc's length except every fifth
    token, which is invalid (scale 0) with valid tokens after it."""
    _, q_n, tq, nd, td, d, _ = case
    q, grid, lens = tiling_case_arrays(case)
    rng = np.random.default_rng(12)
    qi8 = np.clip(np.rint(q * 40), -127, 127).astype(np.int8)
    qs = rng.uniform(0.002, 0.01, q_n * tq).astype(np.float32)
    qs[np.all(qi8 == 0, axis=1)] = 0.0
    gi8 = np.clip(np.rint(grid * 40), -127, 127).astype(np.int8)
    sc = rng.uniform(0.002, 0.01, (nd, td)).astype(np.float32)
    sc[np.arange(td)[None, :] >= lens[:, None]] = 0.0
    sc[:, 3::5] = 0.0
    return (torch.from_numpy(qi8).to(device), torch.from_numpy(qs).to(device),
            torch.from_numpy(gi8).to(device), torch.from_numpy(sc).to(device, torch.bfloat16), tq)


def mega_corpus(device, n_docs=MEGA_DOCS, dim=128, seed=0):
    """scripts/profile_megascale.py's corpus: numpy topics (seed 0) and
    doclens (seed 1, uniform 100-220), tokens unit(topic + 0.08 noise) made
    on the card chunk by chunk. Returns (chunk iterator, training sample,
    doclens, topics)."""
    from nextplaid_tpu_torch.index.build import DeviceChunk

    rng = np.random.default_rng(seed)
    topics = rng.standard_normal((MEGA_TOPICS, dim)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    lens = np.random.default_rng(seed + 1).integers(
        MEGA_LEN[0], MEGA_LEN[1] + 1, size=n_docs).astype(np.int32)
    topics_dev = torch.from_numpy(topics).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)

    def tokens(n):
        ids = torch.randint(0, MEGA_TOPICS, (n,), generator=gen, device=device)
        v = topics_dev[ids] + 0.08 * torch.randn(n, dim, generator=gen, device=device)
        return v / v.norm(dim=1, keepdim=True)

    sample = tokens(MEGA_SAMPLE_TOKENS)

    def chunks():
        for lo in range(0, n_docs, MEGA_CHUNK_DOCS):
            dl = lens[lo : lo + MEGA_CHUNK_DOCS]
            yield DeviceChunk(tokens=tokens(int(dl.sum())), doclens=dl)

    return chunks(), sample, lens, topics


def mega_queries(topics, num=128, tokens=32, dim=128, seed=9):
    """scripts/profile_megascale.py's make_queries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        t = topics[rng.integers(0, len(topics), size=tokens)]
        q = (t + 0.08 * rng.standard_normal((tokens, dim))).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        out.append(q)
    return out


def recall_at_10(results, oracle):
    return float(np.mean([
        len(set(r.passage_ids) & set(o.passage_ids)) / max(len(o.passage_ids), 1)
        for r, o in zip(results, oracle)
    ]))


def check_results(results, n, k=10):
    if len(results) != n or any(
        len(r.passage_ids) != k or not np.all(np.isfinite(r.scores))
        or np.any(np.diff(r.scores) > 0) for r in results
    ):
        raise AssertionError(f"search results are not {k} finite, sorted hits per query")


def scifact_phases(device, mk):
    """The first slice's main path (bf16 pin) and the int8 pin of the same index, then
    the mutation phase on that index. Returns the two kernels' entries of
    the kernels line, the mutation phase's numbers, the corpus's topics
    and queries, and each pin's p50 QPS of the sequential passes; leaves a
    copy of the index as built at SERVICE_SRC."""
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index_from_device, search_batch,
    )
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    path = os.path.join(WORK_DIR, "scifact_scale")
    try:
        doclens = make_doclens()
        tokens, topics = make_corpus_device(doclens, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = create_index_from_device(tokens, doclens, path, IndexConfig(nbits=4, seed=42))
        torch.cuda.synchronize()
        index_build_s = time.perf_counter() - t0
        del tokens
        t0 = time.perf_counter()
        unpinned = DeviceIndex.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = unpinned.with_token_grid(dtype="bf16")
        torch.cuda.synchronize()
        pin_s = time.perf_counter() - t0
        if index.token_grid is None:
            raise AssertionError("the bf16 token grid was not pinned")
        grid = index.token_grid
        grid_mb = grid.numel() * grid.element_size() / 2**20
        print(f"build/load/pin: {meta.num_documents} docs, {meta.num_embeddings} tokens, "
              f"K {meta.num_partitions}; build {index_build_s:.2f} s, load {load_s:.2f} s, "
              f"pin {pin_s:.2f} s; grid {tuple(grid.shape)} bf16 = {grid_mb:.1f} MiB; "
              f"allocated {torch.cuda.memory_allocated() / 2**20:.1f} MiB", flush=True)

        queries = make_queries(topics)
        n_eval = 64
        oracle = search_batch(unpinned, queries[:n_eval],
                              SearchParameters(top_k=10, mode="exact", stage1_precision="highest"))
        params = SearchParameters(top_k=10, stage1_precision="default")
        q_arr, _ = _pad_queries(queries, index.dim)
        tq = q_arr.shape[1]
        q_dev = torch.from_numpy(q_arr.reshape(-1, index.dim)).to(device)
        entries, seq_qps = [], {}
        for label, pinned in (("bf16", index), ("int8", None)):
            if pinned is None:
                del index, grid
                gc.collect()
                t0 = time.perf_counter()
                pinned = unpinned.with_token_grid(dtype="int8")
                torch.cuda.synchronize()
                pin_s = time.perf_counter() - t0
                if pinned.token_scales is None:
                    raise AssertionError("the int8 token grid was not pinned")
                g8 = pinned.token_grid
                print(f"int8 pin: {pin_s:.2f} s; grid {tuple(g8.shape)} int8 + scales = "
                      f"{(g8.numel() + 2 * pinned.token_scales.numel()) / 2**20:.1f} MiB",
                      flush=True)
            kernel = mk.maxsim_grid_scores if label == "bf16" else mk.maxsim_grid_scores_int8i
            search_batch(pinned, queries, params)  # warm-up
            kernel.launches = 0
            pass_s, results = [], None
            for _ in range(TIMED_PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results = search_batch(pinned, queries, params)
                pass_s.append(time.perf_counter() - t0)
            launches = kernel.launches
            if launches < TIMED_PASSES:
                raise AssertionError(
                    f"the {label} path launched its kernel {launches} times in "
                    f"{TIMED_PASSES} passes"
                )
            check_results(results, NUM_QUERIES)
            qps = [NUM_QUERIES / s for s in pass_s]
            recall = recall_at_10(results[:n_eval], oracle)

            # The kernel alone at the path's shapes, beside its plain version.
            if label == "bf16":
                plain = mk.maxsim_grid_scores_reference
                qflat = q_dev.to(torch.bfloat16)
                doclens_g = torch.zeros(grid.shape[0], dtype=torch.int32, device=device)
                doclens_g[: index.num_docs_padded] = index.doclens
                args = (qflat, grid, doclens_g, tq)
                bound_ms, bound_by, dense_ms = maxsim_bound(qflat, grid, doclens_g, tq)
                extra = (f", dense-grid bound {dense_ms:.3f} ms, tile waste "
                         f"{100 * tile_waste(doclens_g):.1f}%")
            else:
                plain = mk.maxsim_grid_scores_int8i_reference
                qi8, qs = quantize_queries_int8(q_dev)
                args = (qi8, qs, pinned.token_grid, pinned.token_scales, tq)
                bound_ms, bound_by = maxsim_bound_int8(
                    qi8, [pinned.token_grid], [pinned.token_scales], NUM_QUERIES)
                extra = f", tile waste {100 * tile_waste(int8_row_bounds(pinned.token_scales)):.1f}%"
            max_err = check_kernel(kernel, plain, args,
                                   f"{label} path {NUM_QUERIES}q x {args[-3].shape[0]} rows")
            kernel_ms = time_ms(lambda: kernel(*args), reps=20)
            plain_ms = time_ms(lambda: plain(*args), reps=3)
            print(f"search [{label} grid]: {NUM_QUERIES} queries x {TIMED_PASSES} passes, "
                  f"p50 {statistics.median(qps):.1f} QPS (min {min(qps):.1f}, max {max(qps):.1f}); "
                  f"kernel {kernel_ms:.3f} ms/pass, bound {bound_ms:.3f} ms "
                  f"({bound_by}; {100 * bound_ms / kernel_ms:.1f}% of it){extra}; plain version "
                  f"{plain_ms:.3f} ms; recall@10 vs f32 oracle {recall:.4f} on {n_eval} queries; "
                  f"kernel launches {launches}", flush=True)
            floor = MIN_RECALL if label == "bf16" else MIN_RECALL_INT8
            if recall < floor:
                raise AssertionError(f"{label} recall@10 {recall} < {floor}")
            entries.append((label, launches, max_err, kernel_ms, plain_ms, bound_ms, bound_by))
            seq_qps[label] = statistics.median(qps)
        del pinned, unpinned, q_dev, oracle
        gc.collect()
        torch.cuda.empty_cache()
        # The service phase serves this index as built, before the mutations.
        shutil.rmtree(SERVICE_SRC, ignore_errors=True)
        shutil.copytree(path, SERVICE_SRC)
        return (entries, mutation_phase(device, mk, path, topics, queries), (topics, queries),
                seq_qps)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


def grid_only_phase(device, mk, n_docs=MEGA_DOCS):
    """Grid-only int8 serving with the device refinement rerank at full
    width, then the staged path on the full index loaded for the oracle.
    Returns the int8 kernel's numbers and the bf16 kernel's staged ones."""
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index_streamed,
        load_grid_only, search_batch, search_batch_async,
    )
    from nextplaid_tpu_torch.index.exact import (
        _finalize_topk_perm, quantize_queries_int8, refine_own_topk_device,
    )
    from nextplaid_tpu_torch.index.search import _pad_queries

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    path = os.path.join(WORK_DIR, "megascale")
    try:
        chunks, sample, lens, topics = mega_corpus(device, n_docs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = create_index_streamed(
            chunks, path, IndexConfig(nbits=2, seed=42),
            sample_tokens=sample, est_total_tokens=int(lens.sum()),
        )
        build_s = time.perf_counter() - t0
        del sample
        gc.collect()
        torch.cuda.empty_cache()
        print(f"grid-only build: {meta.num_documents} docs, {meta.num_embeddings} tokens, "
              f"K {meta.num_partitions}, nbits 2; create_index_streamed {build_s:.2f} s",
              flush=True)
        host_load_check(path)

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        go = load_grid_only(path, dtype="int8")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if go.refine_side != "device" or len(go.grid_buckets) < 2 or not go.scale_buckets:
            raise AssertionError(
                f"expected a bucketed int8 grid with device refinement, got "
                f"{len(go.grid_buckets)} buckets, refine_side {go.refine_side!r}"
            )
        grid_gb = sum(g.numel() + 2 * s.numel() for g, s in zip(go.grid_buckets, go.scale_buckets)) / 1e9
        buckets = ", ".join(f"Td {g.shape[1]} x {g.shape[0]} rows" for g in go.grid_buckets)
        print(f"grid-only load: {load_s:.2f} s; buckets [{buckets}]; grid + scales "
              f"{grid_gb:.3f} GB; refine tables {(go.codes.numel() * 4 + go.residuals.numel()) / 1e9:.3f} GB "
              f"on the device; allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB "
              f"(peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB)", flush=True)

        queries = mega_queries(topics)
        params = SearchParameters(top_k=10, stage1_precision="default")
        batches = [queries[s : s + MEGA_BATCH] for s in range(0, len(queries), MEGA_BATCH)]
        search_batch(go, batches[0], params)  # warm-up
        torch.cuda.synchronize()
        kernel = mk.maxsim_grid_scores_int8i
        kernel.launches = 0
        pass_s, refined = [], None
        per_pass = MEGA_IN_FLIGHT * MEGA_BATCH
        for _ in range(MEGA_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = [search_batch_async(go, batches[i % len(batches)], params)
                       for i in range(MEGA_IN_FLIGHT)]
            out = [p.result() for p in pending]
            pass_s.append(time.perf_counter() - t0)
            refined = out[0]
        launches = kernel.launches
        want = MEGA_PASSES * MEGA_IN_FLIGHT * len(go.grid_buckets)
        if launches < want:
            raise AssertionError(f"grid-only path launched the int8 kernel {launches} times, "
                                 f"expected {want}")
        check_results(refined, MEGA_BATCH)
        qps = [per_pass / s for s in pass_s]
        lat = []
        for q in queries[:10]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search_batch(go, [q], params)
            lat.append(1e3 * (time.perf_counter() - t0))
        unrefined = search_batch(go, batches[0], SearchParameters(
            top_k=10, stage1_precision="default", refine_depth=-1))
        check_results(unrefined, MEGA_BATCH)

        # One 64-query batch, piece by piece: kernel per bucket, finalize,
        # refine; and the kernel against its plain version at these shapes.
        q_arr, q_mask = _pad_queries(batches[0], go.dim)
        tq = q_arr.shape[1]
        q_dev = torch.from_numpy(q_arr).to(device)
        m_dev = torch.from_numpy(q_mask).to(device)
        qi8, qs = quantize_queries_int8(q_dev.reshape(-1, go.dim))
        grids, scales = list(go.grid_buckets), list(go.scale_buckets)
        max_err = max(
            check_kernel(kernel, mk.maxsim_grid_scores_int8i_reference,
                         (qi8, qs, g, s, tq), f"grid-only bucket Td {g.shape[1]}, {MEGA_BATCH}q")
            for g, s in zip(grids, scales)
        )
        kernel_ms = time_ms(lambda: [kernel(qi8, qs, g, s, tq) for g, s in zip(grids, scales)], reps=5)
        plain_ms = time_ms(lambda: [mk.maxsim_grid_scores_int8i_reference(qi8, qs, g, s, tq)
                                    for g, s in zip(grids, scales)], reps=1)
        bound_ms, bound_by = maxsim_bound_int8(qi8, grids, scales, MEGA_BATCH)
        waste = tile_waste(torch.cat([int8_row_bounds(s) for s in scales]))
        bounds = torch.cumsum(torch.tensor([0] + [g.shape[0] for g in grids]), 0).tolist()
        perms = [go.grid_perm[bounds[b] : bounds[b + 1]] for b in range(len(grids))]
        blocks = [kernel(qi8, qs, g, s, tq) for g, s in zip(grids, scales)]
        depth = max(4 * params.top_k, 32)
        finalize_ms = time_ms(lambda: _finalize_topk_perm(blocks, perms, None, depth), reps=5)
        cand, _ = _finalize_topk_perm(blocks, perms, None, depth)
        refine_ms = time_ms(lambda: refine_own_topk_device(go, q_dev, m_dev, cand, 10), reps=5)
        print(f"grid-only search: {MEGA_PASSES} passes of {MEGA_IN_FLIGHT} batches x {MEGA_BATCH} "
              f"queries in flight, p50 {statistics.median(qps):.2f} QPS (min {min(qps):.2f}, "
              f"max {max(qps):.2f}); wall {1e3 * statistics.median(pass_s) / MEGA_IN_FLIGHT:.2f} "
              f"ms/batch; batch-1 p50 {statistics.median(lat):.2f} ms; per 64-query batch: int8 "
              f"kernel {kernel_ms:.3f} ms over {len(grids)} buckets, bound {bound_ms:.3f} ms "
              f"({bound_by}; {100 * bound_ms / kernel_ms:.1f}% of it; tile waste {100 * waste:.1f}%), top-{depth} finalize "
              f"{finalize_ms:.3f} ms, refine {refine_ms:.3f} ms; plain version {plain_ms:.3f} ms; "
              f"kernel launches {launches}", flush=True)
        # Each PendingSearch keeps its index: release them with it.
        del go, grids, scales, blocks, cand, perms, pending, out
        gc.collect()
        torch.cuda.empty_cache()

        # The f32 exhaustive oracle on the first batch.
        # host_load_check left the merge cache: this load reads it.
        t0 = time.perf_counter()
        with merge_cache_flag("1"):
            full = DeviceIndex.load(path)
        oracle = search_batch(full, batches[0], SearchParameters(
            top_k=10, mode="exact", stage1_precision="highest"))
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        r_ref, r_raw = recall_at_10(refined, oracle), recall_at_10(unrefined, oracle)
        print(f"grid-only recall@10 vs the f32 exhaustive scan on {MEGA_BATCH} queries: "
              f"refined {r_ref:.4f}, unrefined {r_raw:.4f} (oracle load from the merge cache + scan "
              f"{oracle_s:.2f} s)",
              flush=True)
        if r_ref < MIN_RECALL or r_raw < MIN_RECALL_INT8:
            raise AssertionError(f"grid-only recall@10 refined {r_ref} < {MIN_RECALL} or "
                                 f"unrefined {r_raw} < {MIN_RECALL_INT8}")
        # This slice's main path: staged search over the same full index.
        # (bf16, union grid, stage 3b)
        staged = staged_phase(full, device, mk, batches, queries, oracle)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        # The tenth slice's path at this scale: the same corpus as sharded
        # int8 grids, after the single-card grids are gone.
        mega = mega_sharded_phase(path, device, mk, batches, unrefined, oracle)
        return (launches, max_err, kernel_ms, plain_ms, bound_ms, bound_by), staged, mega
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


def cuda_holders(min_bytes=32 << 20, limit=12):
    """The live CUDA tensors of at least `min_bytes` that Python can reach,
    largest storage first, each with what refers to it: (their GB, lines)."""
    import types

    gc.collect()
    tensors, seen = [], set()
    for obj in gc.get_objects():
        try:
            if not (torch.is_tensor(obj) and obj.is_cuda):
                continue
            storage = obj.untyped_storage()
        except (ReferenceError, RuntimeError):
            continue
        if storage.nbytes() >= min_bytes and storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            tensors.append(obj)
    tensors.sort(key=lambda t: -t.untyped_storage().nbytes())
    skip = {id(tensors), id(sys._getframe())}

    def owner(ref, obj):
        if isinstance(ref, types.FrameType):
            return f"frame {ref.f_code.co_name}:{ref.f_lineno}"
        if isinstance(ref, dict):
            if "__name__" in ref and "__builtins__" in ref:
                return f"module {ref['__name__']}"
            outer = [type(o).__name__ for o in gc.get_referrers(ref)
                     if getattr(o, "__dict__", None) is ref]
            keys = [k for k, v in ref.items() if v is obj][:2]
            return f"dict{keys} of {outer or 'no object'}"
        if isinstance(ref, (list, tuple)):
            outer = sorted({type(o).__name__ for o in gc.get_referrers(ref) if id(o) not in skip})
            return f"{type(ref).__name__}[{len(ref)}] in {outer}"
        return type(ref).__name__

    lines, top = [], tensors[:limit]
    skip.add(id(top))
    for obj in top:
        refs = [owner(r, obj) for r in gc.get_referrers(obj) if id(r) not in skip]
        lines.append(f"{tuple(obj.shape)} {obj.dtype} {obj.untyped_storage().nbytes() / 1e9:.3f} "
                     f"GB <- {'; '.join(refs[:4]) or 'nothing Python sees'}")
    return sum(t.untyped_storage().nbytes() for t in tensors) / 1e9, lines


def mega_sharded_phase(path, device, mk, batches, unrefined, oracle):
    """Phase (d) of the sharded path: `shard_grid_only(dtype="int8")` of the
    megascale index onto SHARDS shards on the one card, its unrefined top-10
    against the single-card bucketed grid's (`unrefined`, cut ties aside)
    and recall@10 against the f32 oracle, on the first batch; QPS over the
    batches of 64. Returns the int8 kernel's numbers of the phase."""
    from nextplaid_tpu_torch.index import SearchParameters
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.parallel import ShardedGridIndex, make_mesh, search_batch_sharded_grid
    from nextplaid_tpu_torch.parallel import sharded as ps

    kernel = mk.maxsim_grid_scores_int8i
    mesh = make_mesh(devices=[device] * SHARDS)
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    held_gb, held = cuda_holders()
    print(f"sharded (d): {before_gb:.3f} GB allocated before the load; {held_gb:.3f} GB of it in "
          f"tensors Python reaches: {' | '.join(held) or 'none'}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg = ShardedGridIndex.shard_grid_only(path, mesh, "int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grid_gb = sum(g.numel() + 2 * sc.numel() for g, sc in zip(sg.grids, sg.scales)) / 1e9
    params = SearchParameters(top_k=10)
    search_batch_sharded_grid(sg, batches[0], params)  # warm-up
    take_launches(kernel)
    pass_s, got = [], None
    for _ in range(MEGA_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [search_batch_sharded_grid(sg, b, params) for b in batches]
        pass_s.append(time.perf_counter() - t0)
        got = results[0]
    launches = take_launches(kernel)
    if launches < MEGA_PASSES * len(batches) * SHARDS:
        raise AssertionError(f"sharded (d): {launches} int8 kernel launches")
    check_results(got, MEGA_BATCH)
    gap = assert_same_shard_topk(got, unrefined,
                                 "sharded (d) vs the single-card unrefined int8 grid")
    recall = recall_at_10(got, oracle)
    if recall < MIN_RECALL_INT8:
        raise AssertionError(f"sharded (d): recall@10 {recall} < {MIN_RECALL_INT8}")
    q_arr, _ = _pad_queries(batches[0], sg.dim)
    q_dev = torch.from_numpy(q_arr).to(device)
    qi8, qs = quantize_queries_int8(q_dev.reshape(-1, sg.dim))
    err = check_kernel(kernel, mk.maxsim_grid_scores_int8i_reference,
                       (qi8, qs, sg.grids[0], sg.scales[0], q_arr.shape[1]),
                       f"sharded int8 megascale shard 0, {MEGA_BATCH}q x {sg.rows} rows")
    shard_ms = [time_ms(lambda i=i: ps.shard_grid_scores(sg, i, q_dev), reps=3)
                for i in range(SHARDS)]
    take_launches(kernel)
    bound_ms, bound_by = maxsim_bound_int8(qi8, [sg.grids[0]], [sg.scales[0]], MEGA_BATCH)
    qps = [len(batches) * MEGA_BATCH / x for x in pass_s]
    print(f"sharded (d) [megascale int8 grid, {SHARDS} shards on one card]: shard_grid_only "
          f"{load_s:.2f} s, {sg.rows} rows x Td {sg.grid_td} a shard, grid + scales {grid_gb:.3f} "
          f"GB, peak allocated {peak_gb:.3f} GB ({before_gb:.3f} GB allocated before the load); "
          f"batches of {MEGA_BATCH}: p50 "
          f"{statistics.median(qps):.2f} QPS (min {min(qps):.2f}, max {max(qps):.2f}); per-shard "
          f"kernel {', '.join(f'{x:.3f}' for x in shard_ms)} ms (shard 0's bound {bound_ms:.3f} "
          f"ms, {bound_by}); unrefined top-10 = the single-card grid's (largest score gap "
          f"{gap:.3e}, bound {SHARD_ATOL:.0e}), recall@10 vs the f32 oracle {recall:.4f}; kernel "
          f"launches {launches}", flush=True)
    del sg
    gc.collect()
    torch.cuda.empty_cache()
    return {"mega_sharded_launches": launches, "mega_sharded_max_abs_err": err,
            "mega_sharded_shard_ms": shard_ms, "mega_sharded_shard_bound_ms": bound_ms,
            "mega_sharded_load_s": load_s, "mega_sharded_topk_gap": gap}


@contextlib.contextmanager
def merge_cache_flag(value):
    """Set NEXT_PLAID_MERGE_CACHE for a load, so that the load takes one
    stated path ("1": cache hit, else native merge + cache store), and put
    the caller's setting back after it."""
    flag = os.environ.get("NEXT_PLAID_MERGE_CACHE")
    os.environ["NEXT_PLAID_MERGE_CACHE"] = value
    try:
        yield
    finally:
        if flag is None:
            del os.environ["NEXT_PLAID_MERGE_CACHE"]
        else:
            os.environ["NEXT_PLAID_MERGE_CACHE"] = flag


def host_load_check(path):
    """The host side of a load on the megascale index, with the merge cache
    forced on: the first `load_host_arrays` merges the chunks natively and
    stores the cache beside the index, the second is a cache hit; both, and
    the native merge itself, equal numpy's concatenation of the chunks."""
    from nextplaid_tpu_torch.index.container import load_host_arrays
    from nextplaid_tpu_torch.storage import merge_cache, native
    from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json

    layout = IndexLayout(path)
    n_chunks = load_json(layout.metadata)["num_chunks"]
    code_paths = [str(layout.chunk_codes(i)) for i in range(n_chunks)]
    res_paths = [str(layout.chunk_residuals(i)) for i in range(n_chunks)]
    with merge_cache_flag("1"):
        t0 = time.perf_counter()
        merged = load_host_arrays(path)
        merge_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cached = load_host_arrays(path)
        hit_s = time.perf_counter() - t0
    if merge_cache.load_merged(layout.root, code_paths, res_paths) is None:
        raise AssertionError("load_host_arrays stored no merge cache")
    t0 = time.perf_counter()
    codes = np.concatenate([np.load(p) for p in code_paths])
    residuals = np.concatenate([np.load(p) for p in res_paths])
    numpy_s = time.perf_counter() - t0
    packed_dim = residuals.shape[1]
    equal = (
        np.array_equal(native.merge_chunk_payloads(code_paths, codes.dtype), codes)
        and np.array_equal(native.merge_chunk_payloads(res_paths, np.uint8, (packed_dim,)), residuals)
        and all(np.array_equal(h["codes"], codes.astype(np.int32))
                and np.array_equal(h["residuals"], residuals) for h in (merged, cached))
    )
    cache_gb = sum(os.path.getsize(os.path.join(path, "merged", n))
                   for n in ("codes.npy", "residuals.npy")) / 1e9
    print(f"load host: {n_chunks} chunks, {codes.nbytes / 1e9:.3f} GB of codes and "
          f"{residuals.nbytes / 1e9:.3f} GB of residuals; load_host_arrays merged natively "
          f"and stored the cache ({cache_gb:.3f} GB) in {merge_s:.2f} s, then a cache hit in "
          f"{hit_s:.3f} s; numpy's concatenation {numpy_s:.2f} s; native merge == numpy: "
          f"{equal}", flush=True)
    if not equal:
        raise AssertionError("the native merge or the merge cache differs from numpy's concatenation")


def variants_phase(device, mv, mk):
    """The variant sweep at its shape: every variant of csrc/maxsim_variants.cu
    against its plain version, then timed with its plan beside the
    one-big-dot floor and its own bound. Returns the family's entry of the
    kernels line."""
    tq = mv.SWEEP_SHAPE["tq"]
    q_n = 64
    qflat, grid, lens, addmask = mv.sweep_inputs(device, q_n)
    kernel = mv.maxsim_variant_scores
    plain_max = mv.maxsim_variant_scores_reference(qflat, grid, lens, tq)
    plain_ms = time_ms(lambda: mv.maxsim_variant_scores_reference(qflat, grid, lens, tq), reps=3)
    floor_ms = time_ms(lambda: mv.one_big_dot_floor(qflat, grid), reps=5)
    valid_rows = int(lens.sum())
    all_rows = grid.shape[0] * grid.shape[1]
    nbytes = qflat.numel() * 2 + grid.numel() * 2 + lens.numel() * 4 + q_n * grid.shape[0] * 4
    t_bytes = nbytes / PEAK_HBM_BYTES

    def bound(rows):
        t_ops = 2.0 * qflat.shape[0] * grid.shape[2] * rows / PEAK_BF16_FLOPS
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    # MaxSim needs the valid rows' products; the probe's sum needs every row's.
    bound_ms, bound_by = bound(valid_rows)
    probe_bound_ms, _ = bound(all_rows)

    def call(variant):
        name, mask, geometry, reduce, dots = variant
        arg = addmask if mask == "additive" else lens
        return kernel(qflat, grid, arg, tq, mask=mask, geometry=geometry,
                      reduce=reduce, dots_only=dots)

    # Each variant against its plain version (launches here are not counted).
    plain_probe, err_max, err_probe = {}, 0.0, 0.0
    for variant in mv.SWEEP_VARIANTS:
        name, mask, geometry, reduce, dots = variant
        got = call(variant)
        torch.cuda.synchronize()
        if dots:
            if geometry[0] not in plain_probe:
                plain_probe[geometry[0]] = mv.maxsim_variant_scores_reference(
                    qflat, grid, lens, tq, geometry=geometry, dots_only=True)
            want, rtol = plain_probe[geometry[0]], PROBE_RTOL
        else:
            want, rtol = plain_max, KERNEL_RTOL
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"variant {name}: output is not finite or misshaped")
        err = float((got - want).abs().max())
        tol = rtol * max(float(want.abs().max()), 1.0)
        if not err <= tol:
            raise AssertionError(f"variant {name} disagrees with its plain version: {err} > {tol}")
        if dots:
            err_probe = max(err_probe, err)
        else:
            err_max = max(err_max, err)
    print(f"kernel check [variants]: {len(mv.SWEEP_VARIANTS)} variants at grid {tuple(grid.shape)}, "
          f"{q_n} queries: max|kernel - plain| = {err_max:.3e} (tolerance {KERNEL_RTOL:g} x max|score| "
          f"{float(plain_max.abs().max()):.3f}); dots-only probe {err_probe:.3e} (tolerance "
          f"{PROBE_RTOL:g} x max|sum|)", flush=True)

    # The sweep itself: launches counted from here.
    kernel.launches = 0
    times = {}
    for variant in mv.SWEEP_VARIANTS:
        times[variant[0]] = time_ms(lambda: call(variant), reps=5)
    launches = kernel.launches
    if launches < 6 * len(mv.SWEEP_VARIANTS):
        raise AssertionError(f"the sweep launched the variant kernel {launches} times")
    print(f"variant sweep: bound {bound_ms:.3f} ms ({bound_by}; {valid_rows} valid rows' products "
          f"at 989 TFLOP/s), probe's bound {probe_bound_ms:.3f} ms ({all_rows} rows), one-big-dot "
          f"floor (torch.matmul) {floor_ms:.3f} ms, plain version {plain_ms:.3f} ms; kernel "
          f"launches {launches}", flush=True)
    plans = {}
    for name, mask, geometry, reduce, dots in mv.SWEEP_VARIANTS:
        plan = mv.variant_plan(q_n, tq, grid.shape[2], mask=mask, geometry=geometry,
                               reduce=reduce, dots_only=dots)
        plans[name] = dict(n=plan.n, warpgroups=plan.n_wg, stages=plan.stages, rows=plan.rows,
                           docs_per_block=plan.dpb)
        own = probe_bound_ms if dots else bound_ms
        ms = times[name]
        print(f"  variant {name:18s} {ms:8.3f} ms  ({100 * own / ms:5.1f}% of its bound "
              f"{own:.3f} ms, {ms / floor_ms:5.2f} x the floor)  plan: N {plan.n} x {plan.n_wg} "
              f"wg, {plan.stages} stages of {plan.rows} rows, {plan.dpb} docs a block", flush=True)
    best = min((v[0] for v in mv.SWEEP_VARIANTS if not v[4]), key=times.get)
    probe = min((v[0] for v in mv.SWEEP_VARIANTS if v[4]), key=times.get)
    print(f"best MaxSim variant {best} {times[best]:.3f} ms ({100 * bound_ms / times[best]:.1f}% "
          f"of {bound_ms:.3f} ms); best probe {probe} {times[probe]:.3f} ms "
          f"({100 * probe_bound_ms / times[probe]:.1f}% of {probe_bound_ms:.3f} ms), "
          f"{times[probe] / floor_ms:.3f} x the one-big-dot floor", flush=True)
    # The served bf16 kernel at the sweep's shape, beside the best variant.
    served = mk.maxsim_grid_scores(qflat, grid, lens, tq)  # [Q, ND]; the variants give [ND, Q]
    torch.cuda.synchronize()
    served_err = float((served.T - plain_max).abs().max())
    tol = KERNEL_RTOL * max(float(plain_max.abs().max()), 1.0)
    if not served_err <= tol:
        raise AssertionError(f"bf16 kernel at the sweep's shape disagrees: {served_err} > {tol}")
    served_ms = time_ms(lambda: mk.maxsim_grid_scores(qflat, grid, lens, tq), reps=10)
    print(f"served bf16 kernel at the sweep's shape: {served_ms:.3f} ms ({100 * bound_ms / served_ms:.1f}% "
          f"of the bound; best variant {best} {times[best]:.3f} ms); max|kernel - plain| = "
          f"{served_err:.3e}", flush=True)
    entry = kernel_entry(
        "maxsim_variant_scores", "nextplaid_tpu_torch/csrc/maxsim_variants.cu",
        "scripts/profile_kernel_variants.py:300", launches, err_max, times[best], plain_ms,
        bound_ms, bound_by)
    entry.update(
        library_ms=floor_ms,
        library_note="one-big-dot floor: bf16 torch.matmul of the same contraction with a "
                     "per-doc sum; it computes the probe's function, not MaxSim",
        best_variant=best, variants_ms=times, variant_plans=plans, probe_max_abs_err=err_probe,
        probe_ms=times[probe], probe_bound_ms=probe_bound_ms,
        probe_to_floor=times[probe] / floor_ms, served_bf16_ms_at_sweep_shape=served_ms)
    del qflat, grid, lens, addmask, plain_max, plain_probe
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def assert_same_topk(got, want, tol, label, atol=None):
    """Score-sorted lists equal up to ties: scores within `tol` relative and
    `atol` absolute (`tol` when None), and a doc in only one list must score
    within that bound of the other list's last score. Returns the largest
    gap between the lists' scores, rank for rank."""
    atol = tol if atol is None else atol
    gap = 0.0
    for g, w in zip(got, want):
        if len(g.passage_ids) != len(w.passage_ids):
            raise AssertionError(f"{label}: result lengths differ")
        if not np.allclose(g.scores, w.scores, rtol=tol, atol=atol):
            raise AssertionError(f"{label}: scores differ beyond rtol {tol}, atol {atol}")
        if len(g.scores):
            gap = max(gap, float(np.max(np.abs(np.subtract(g.scores, w.scores)))))
        g_map, w_map = dict(zip(g.passage_ids, g.scores)), dict(zip(w.passage_ids, w.scores))
        kth = w.scores[-1] if len(w.scores) else 0.0
        for doc in set(g_map) ^ set(w_map):
            score = g_map.get(doc, w_map.get(doc))
            if abs(score - kth) > atol + tol * abs(kth):
                raise AssertionError(f"{label}: doc {doc} (score {score}) is in one top-k only")
    return gap


def stage4_union(index, queries, qmask, shapes):
    """The batch's union of candidate ids at stage 4 of `search_pipeline` on
    a flat-centroid index: stages 1-3 as the pipeline runs them."""
    from nextplaid_tpu_torch.index import search as S

    q_n, tq, d = queries.shape
    k = index.num_centroids
    q_in, cent = queries.float(), index.centroids
    if shapes.stage1_precision != "highest":
        q_in, cent = q_in.to(torch.bfloat16).float(), cent.to(torch.bfloat16).float()
    s_masked = (q_in.reshape(-1, d) @ cent.T).view(q_n, tq, k).masked_fill(
        ~qmask[:, :, None], float("-inf"))
    cells, weights = S._dedup_cells(*S._select_cells(s_masked, qmask, shapes, k), k)
    union_ids, _, _ = S._prune_candidates(index, cells, weights, shapes, s_masked=s_masked,
                                          qmask=qmask)
    return union_ids


def stage4_kernel_args(index, queries, qmask, shapes, union_ids=None):
    """The bf16 kernel's arguments at stage 4 of `search_pipeline` on a
    flat-centroid index: its union grid (of `union_ids`, else of
    `stage4_union`) and its masked bf16 queries. Returns (args, docs in the
    union)."""
    from nextplaid_tpu_torch.index import search as S

    q_n, tq, d = queries.shape
    if union_ids is None:
        union_ids = stage4_union(index, queries, qmask, shapes)
    grid, doclens = S._build_union_grid(index, union_ids, shapes)
    qflat = torch.where(qmask[:, :, None], queries.float(), torch.zeros((), device=grid.device))
    args = (qflat.reshape(q_n * tq, d).to(torch.bfloat16), grid, doclens, tq)
    return args, int((union_ids < index.num_documents).sum())


def exact_grid_args(index, queries):
    """The bf16 kernel's arguments of the exact search over `index`'s pinned
    bf16 grid for the query list `queries`, padded as `search_batch` pads
    them."""
    from nextplaid_tpu_torch.index.search import _pad_queries

    q_arr, _ = _pad_queries(queries, index.dim)
    q_dev = torch.from_numpy(q_arr.reshape(-1, index.dim)).to(index.device, torch.bfloat16)
    lens = torch.zeros(index.token_grid.shape[0], dtype=torch.int32, device=index.device)
    lens[: index.num_docs_padded] = index.doclens
    return q_dev, index.token_grid, lens, q_arr.shape[1]


UNION_CHECK_ROWS = 4096  # grid rows compared at once


def union_grid_check(index, union_ids, shapes, label):
    """csrc/union_grid.cu against its plain version (`_build_union_grid_eager`)
    on one union of a path: doclens and dead slots (token rows past a doc's
    length, rows past Cmax) exact, live elements within one bf16 ulp. Both
    timed (CUDA events), beside the bound of the bytes the build moves at
    the HBM rate: the whole grid written, each live token's code and packed
    residual and the centroid table read once, and the ids and doclens
    (`live_bound_ms` writes live slots only). Returns the kernel's numbers
    for the kernels line; the launches of the check and the timing are
    taken off the kernel's count."""
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.ops import union_grid as U

    before = U.union_grid.launches
    grid, lens = S._build_union_grid(index, union_ids, shapes)
    if U.union_grid.launches != before + 1:
        raise AssertionError(f"{label}: _build_union_grid did not launch the union grid kernel")
    want_grid, want_lens = S._build_union_grid_eager(index, union_ids, shapes)
    if grid.shape != want_grid.shape or not torch.equal(lens, want_lens):
        raise AssertionError(f"{label}: union grid {tuple(grid.shape)} or its doclens differ "
                             f"from the eager loop's {tuple(want_grid.shape)}")
    td = shapes.doc_token_cap
    t_ar = torch.arange(grid.shape[1], device=grid.device)
    dead_nonzero = same = n_live = max_ulp = 0
    max_err = 0.0
    for r in range(0, grid.shape[0], UNION_CHECK_ROWS):
        g, w = grid[r : r + UNION_CHECK_ROWS], want_grid[r : r + UNION_CHECK_ROWS]
        live = t_ar[None, :] < torch.clamp(lens[r : r + UNION_CHECK_ROWS], max=td)[:, None]
        dead_nonzero += int(torch.count_nonzero(g[~live]))
        got, want = g[live], w[live]
        if not got.numel():
            continue
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        same += int((ulps == 0).sum())
        n_live += got.numel()
        max_ulp = max(max_ulp, int(ulps.max()))
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))
    del want_grid, want_lens
    share = same / max(n_live, 1)
    if dead_nonzero or max_ulp > 1:
        raise AssertionError(f"{label}: union grid kernel vs eager loop: {dead_nonzero} nonzero "
                             f"dead elements, max {max_ulp} bf16 ulp")
    kernel_ms = time_ms(lambda: S._build_union_grid(index, union_ids, shapes), reps=5)
    plain_ms = time_ms(lambda: S._build_union_grid_eager(index, union_ids, shapes), reps=1)
    U.union_grid.launches = before
    rows, td_k, d = grid.shape
    live_tokens = int(torch.clamp(lens, max=td).sum())
    reads = (live_tokens * (4 + d * index.nbits // 8) + index.num_centroids * d * 4 + rows * 12)
    bound_ms = 1e3 * (rows * td_k * d * 2 + reads) / PEAK_HBM_BYTES
    live_bound_ms = 1e3 * (live_tokens * d * 2 + reads) / PEAK_HBM_BYTES
    print(f"union grid kernel [{label}]: grid {tuple(grid.shape)} of {union_ids.shape[0]} ids, "
          f"nbits {index.nbits}, {live_tokens} live tokens "
          f"({100 * live_tokens / (rows * td_k):.2f}% of the slots); doclens and dead slots exact, "
          f"live elements bit-identical {share:.6f}, max {max_ulp} ulp (max abs {max_err:.3g}); "
          f"kernel {kernel_ms:.3f} ms, eager loop {plain_ms:.3f} ms, bytes bound {bound_ms:.3f} ms "
          f"({100 * bound_ms / kernel_ms:.1f}% of it; live slots only {live_bound_ms:.3f} ms)",
          flush=True)
    return {"max_abs_err": max_err, "max_ulp": max_ulp, "bit_identical_share": share,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "live_bound_ms": live_bound_ms, "shape": list(grid.shape),
            "live_tokens": live_tokens}


# Stage 3b's kernel vs its plain version: the same f32 lookups and maxima,
# the sum over query tokens in another order; allowed |difference| is this
# much absolute plus this fraction of the score.
APPROX_CODES_TOL = 1e-6


def stage3b_args(index, queries, qmask, shapes):
    """The arguments stage 3b gets in `search_pipeline` on a flat-centroid
    index at a "codes" point, taken from one run of stages 1-3
    (`stage4_union`, which runs stage 3b too). Returns the arguments."""
    from nextplaid_tpu_torch.index import search as S

    seen = []
    scores = S._approx_codes_scores

    def capture(*args):
        seen.append(args)
        return scores(*args)

    S._approx_codes_scores = capture
    try:
        stage4_union(index, queries, qmask, shapes)
    finally:
        S._approx_codes_scores = scores
    if len(seen) != 1:
        raise AssertionError(f"stages 1-3 ran stage 3b {len(seen)} times, not once")
    return seen[0]


def approx_codes_gap(got, want, label):
    """The largest absolute and relative gap of stage-3b scores `got` to
    `want`; raises where a gap passes APPROX_CODES_TOL or where `want` is 0
    (masked query tokens, dead slots, ids past the live docs) and `got` is
    not exactly 0."""
    gap = (got - want).abs()
    zeros = want == 0
    if bool((gap > APPROX_CODES_TOL * (1 + want.abs())).any()) or bool((got[zeros] != 0).any()):
        raise AssertionError(f"{label}: stage-3b scores differ by up to {float(gap.max()):.3g} "
                             f"(tolerance {APPROX_CODES_TOL} + that of the score), "
                             f"{int((got[zeros] != 0).sum())} of {int(zeros.sum())} zeros not zero")
    rel = gap[~zeros] / want[~zeros].abs()
    return float(gap.max()), float(rel.max()) if rel.numel() else 0.0


def approx_codes_bytes(index, cand_ids, k, tq, td):
    """What stage 3b's kernel must move through device memory for the pool
    `cand_ids` [Q, pool] against a [Q, K, Tq] f32 table: the table once,
    each live token's code, each slot's id, doclen and offset, the query
    mask and the output. Returns (bytes, live tokens); the table rows it
    looks up, live tokens x Tq x 4 bytes, come from L2."""
    q_n, pool = cand_ids.shape
    safe = torch.clamp(cand_ids, 0, index.num_docs_padded - 1)
    lens = torch.where(cand_ids < index.num_documents, index.doclens[safe], 0)
    live_tokens = int(torch.clamp(lens, max=td).sum())
    moved = (q_n * k * tq * 4 + live_tokens * 4 + q_n * pool * (cand_ids.element_size() + 8)
             + q_n * tq + q_n * pool * 4)
    return moved, live_tokens


def approx_codes_check(index, queries, qmask, shapes, label):
    """csrc/approx_codes.cu against its plain version
    (`_approx_codes_scores_eager` on the table in f64) on one batch's
    stage-3b pool (`approx_codes_gap`), one launch for the stage, and a
    planted fault (the eager loop with each doc's last live token skipped)
    that must fail the same comparison. The kernel alone, the stage (the
    table's transpose and the kernel) and the eager loop timed (CUDA
    events), beside the bound of the bytes the kernel moves at the HBM rate
    (`approx_codes_bytes`; `row_gb`: the table rows it looks up, which L2
    serves). Returns the numbers for the kernels line; the launches of the
    check and the timing are taken off the kernel's count."""
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.ops import approx_codes as A

    before = A.approx_codes.launches
    args = stage3b_args(index, queries, qmask, shapes)
    _, s_masked, qmask, cand_ids, _ = args
    got = S._approx_codes_scores(*args)
    if A.approx_codes.launches != before + 2:
        raise AssertionError(f"{label}: _approx_codes_scores did not launch the stage-3b kernel")
    # The kernel sums the maxima in f64 and rounds once: the eager loop on
    # the table in f64.
    want = S._approx_codes_scores_eager(args[0], s_masked.double(), *args[2:])
    max_abs, max_rel = approx_codes_gap(got, want, label)
    shortened = dataclasses.replace(index, doclens=torch.clamp(index.doclens - 1, min=0))
    skipped = S._approx_codes_scores_eager(shortened, *args[1:])
    fault_gap = float((skipped - want).abs().max())
    try:
        approx_codes_gap(skipped, want, f"{label} (planted fault)")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{label}: the check passed scores with each doc's last token skipped")
    q_n, k, tq = s_masked.shape[0], s_masked.shape[2], s_masked.shape[1]
    pool = cand_ids.shape[1]
    kargs = (s_masked.transpose(1, 2).contiguous(), qmask.contiguous(), cand_ids.contiguous(),
             index.doclens, index.doc_offsets, index.codes, index.num_documents,
             shapes.doc_token_cap)
    kernel_ms = time_ms(lambda: A.approx_codes(*kargs), reps=20)
    stage_ms = time_ms(lambda: S._approx_codes_scores(*args), reps=10)
    plain_ms = time_ms(lambda: S._approx_codes_scores_eager(*args), reps=1)
    A.approx_codes.launches = before
    moved, live_tokens = approx_codes_bytes(index, cand_ids, k, tq, shapes.doc_token_cap)
    bound_ms = 1e3 * moved / PEAK_HBM_BYTES
    row_gb = live_tokens * tq * 4 / 1e9
    print(f"stage-3b kernel [{label}]: {q_n} queries x pool {pool}, K {k}, Tq {tq}, Td "
          f"{shapes.doc_token_cap}, {live_tokens} live tokens ({row_gb:.2f} GB of table rows); "
          f"vs the eager loop max abs {max_abs:.3g}, max rel {max_rel:.3g}, zeros exact; planted "
          f"fault refused (each doc's last token skipped: max abs {fault_gap:.3g}); kernel "
          f"{kernel_ms:.3f} ms, with the transpose {stage_ms:.3f} ms, eager loop "
          f"{plain_ms:.3f} ms, bytes bound "
          f"{bound_ms:.3f} ms ({100 * bound_ms / kernel_ms:.1f}% of it)", flush=True)
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "ms": kernel_ms,
            "stage_ms": stage_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "shape": [q_n, pool, k, tq], "live_tokens": live_tokens, "row_gb": row_gb,
            "fault_gap": fault_gap}


def staged_phase(full, device, mk, batches, queries, oracle):
    """This slice's main path at full width: staged PLAID search over the
    full 473,000-doc index, its union grid built by csrc/union_grid.cu and
    scored by the bf16 MaxSim kernel, one launch of each a batch, and at the
    "codes" points stage 3b one launch of csrc/approx_codes.cu a batch.
    Returns the bf16 kernel's staged numbers, the union grid kernel's and
    the stage-3b kernel's for the kernels line."""
    from nextplaid_tpu_torch.index import SearchParameters, search_batch, search_batch_async
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.index.config import resolve_target_recall
    from nextplaid_tpu_torch.ops import approx_codes as A
    from nextplaid_tpu_torch.ops import union_grid as U

    kernel, union, approx = mk.maxsim_grid_scores, U.union_grid, A.approx_codes
    q_arr, q_mask = S._pad_queries(batches[0], full.dim)
    q_dev = torch.from_numpy(q_arr).to(device)
    m_dev = torch.from_numpy(q_mask).to(device)
    points = [(label, SearchParameters(**STAGED_COMMON, **kw), recorded - RECALL_SLACK)
              for label, kw, recorded in STAGED_POINTS]
    points.append(('preset "quality"', SearchParameters.preset("quality", **STAGED_COMMON),
                   MIN_RECALL_QUALITY))
    total_launches = union_launches = approx_launches = 0
    for label, params, floor in points:
        resolved = resolve_target_recall(params)
        search_batch(full, batches[0], params)  # warm-up
        torch.cuda.synchronize()
        kernel.launches = union.launches = approx.launches = 0
        pass_s, out, pending = [], None, None
        for _ in range(STAGED_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = [search_batch_async(full, batches[i % len(batches)], params)
                       for i in range(MEGA_IN_FLIGHT)]
            out = [p.result() for p in pending]
            pass_s.append(time.perf_counter() - t0)
        launches, u_launches, a_launches = kernel.launches, union.launches, approx.launches
        want_a = launches if resolved.approx_score == "codes" else 0
        if (launches != STAGED_PASSES * MEGA_IN_FLIGHT or u_launches != launches
                or a_launches != want_a):
            raise AssertionError(f"staged [{label}] launched the bf16 kernel {launches} times, "
                                 f"the union grid kernel {u_launches} times and the stage-3b "
                                 f"kernel {a_launches} times in "
                                 f"{STAGED_PASSES * MEGA_IN_FLIGHT} batches")
        total_launches += launches
        union_launches += u_launches
        approx_launches += a_launches
        check_results(out[0], MEGA_BATCH)
        shapes = pending[0].shapes
        if shapes is None or not shapes.rerank_kernel:
            raise AssertionError(f"staged [{label}] did not take the stage-4 kernel route")
        overflow = int(pending[0].overflow.max())
        recall = recall_at_10(out[0], oracle)
        qps = [MEGA_IN_FLIGHT * MEGA_BATCH / s for s in pass_s]
        lat = []
        for q in queries[:5]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search_batch(full, [q], params)
            lat.append(1e3 * (time.perf_counter() - t0))
        # One batch stage by stage, by CUDA events (median of 3 runs).
        runs = []
        for _ in range(3):
            marks = []
            S.search_pipeline(full, q_dev, m_dev, None, shapes, marks=marks)
            torch.cuda.synchronize()
            runs.append({b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])})
        stage = {name: statistics.median(r[name] for r in runs) for name in runs[0]}
        grid_mib = (-(-shapes.max_candidates // 64) * 64 * shapes.doc_token_cap * full.dim * 2) / 2**20
        print(f"staged [{label}]: {resolved.approx_score} nprobe {shapes.nprobe} keep "
              f"{shapes.prune_keep} pool {shapes.prune_pool}, posting budget {shapes.posting_budget}, "
              f"cmax {shapes.max_candidates}, union grid {grid_mib:.0f} MiB; p50 "
              f"{statistics.median(qps):.2f} QPS (min {min(qps):.2f}, max {max(qps):.2f}) with "
              f"{MEGA_IN_FLIGHT} batches x {MEGA_BATCH} in flight; batch-1 p50 "
              f"{statistics.median(lat):.2f} ms; recall@10 {recall:.4f} (floor {floor:.4f}); overflow "
              f"{overflow}; per batch ms: stages 1-2 {stage['stage12']:.3f}, 3 {stage['stage3']:.3f}, "
              f"3b {stage['stage3b']:.3f}, union {stage['union']:.3f}, grid build "
              f"{stage['stage4_grid']:.3f}, stage-4 kernel {stage['stage4_kernel']:.3f}, 5 "
              f"{stage['stage5']:.3f}; kernel launches {launches} bf16, {u_launches} union grid, "
              f"{a_launches} stage 3b (one each per batch)", flush=True)
        if recall < floor:
            raise AssertionError(f"staged [{label}] recall@10 {recall} < {floor}")

    # Once: the scan route (kernel="xla") returns the same top-10.
    label, kw, _ = STAGED_POINTS[0]
    by_kernel = search_batch(full, batches[0], SearchParameters(**STAGED_COMMON, **kw))
    before = (kernel.launches, union.launches)
    by_scan = search_batch(full, batches[0], SearchParameters(kernel="xla", **STAGED_COMMON, **kw))
    if (kernel.launches, union.launches) != before:
        raise AssertionError('kernel="xla" launched the bf16 or the union grid kernel')
    assert_same_topk(by_kernel, by_scan, STAGE4_TOL, f"staged [{label}] kernel vs scan route")
    print(f"staged [{label}]: the scan route (kernel=\"xla\") returns the same top-10 as the kernel "
          f"route (tie rule, tolerance {STAGE4_TOL})", flush=True)

    # Both kernels alone at the stage-4 shape (the largest union grid),
    # beside their plain versions and their bounds.
    label, kw, _ = STAGED_POINTS[1]
    params = SearchParameters(**STAGED_COMMON, **kw)
    shapes = S.PipelineShapes.derive(full, params, MEGA_BATCH, q_arr.shape[1])
    union_ids = stage4_union(full, q_dev, m_dev, shapes)
    union_numbers = union_grid_check(full, union_ids, shapes, f"staged stage 4 [{label}]")
    # Stage 3b's kernel at the largest "codes" pool, the "quality" preset's.
    quality = resolve_target_recall(SearchParameters.preset("quality", **STAGED_COMMON))
    approx_numbers = approx_codes_check(
        full, q_dev, m_dev, S.PipelineShapes.derive(full, quality, MEGA_BATCH, q_arr.shape[1]),
        'staged preset "quality"')
    args, n_union = stage4_kernel_args(full, q_dev, m_dev, shapes, union_ids=union_ids)
    _, grid, doclens, _ = args
    max_err = check_kernel(kernel, mk.maxsim_grid_scores_reference, args,
                           f"stage-4 union grid {tuple(grid.shape)}, {MEGA_BATCH}q")
    kernel_ms = time_ms(lambda: kernel(*args), reps=5)
    plain_ms = time_ms(lambda: mk.maxsim_grid_scores_reference(*args), reps=1)
    bound_ms, bound_by, dense_ms = maxsim_bound(*args)
    print(f"stage-4 kernel [{label}]: union {n_union} docs of cmax {shapes.max_candidates}, "
          f"{int(doclens.sum())} valid tokens; kernel {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}; {100 * bound_ms / kernel_ms:.1f}% of it; tile waste "
          f"{100 * tile_waste(doclens.clamp(max=grid.shape[1])):.1f}%), dense-grid bound {dense_ms:.3f} "
          f"ms, plain version {plain_ms:.3f} ms; staged kernel launches in all {total_launches}",
          flush=True)
    return ({"staged_launches": total_launches, "staged_max_abs_err": max_err,
             "staged_ms": kernel_ms, "staged_plain_ms": plain_ms, "staged_bound_ms": bound_ms,
             "staged_bound_by": bound_by, "staged_shape": list(grid.shape)},
            {"staged_launches": union_launches, **union_numbers},
            {"launches": approx_launches, **approx_numbers})


class _Messages(logging.Handler):
    """Collects the messages of the records a logger passes it."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


TITLE_WORDS = ("retrieval", "protein", "vaccine", "climate", "genome", "neuron", "cohort")


def new_docs(topics, n, seed, dim=128):
    """`n` ingest docs: SciFact-shaped lengths (N(290, 40) clipped to 64-300),
    tokens unit(topic + 0.08 noise) from the corpus's topics with a new seed,
    as host arrays (the update entry points take numpy)."""
    rng = np.random.default_rng(seed)
    out = []
    for n_tok in make_doclens(n, seed=seed):
        v = topics[rng.integers(0, len(topics), n_tok)] + 0.08 * rng.standard_normal((n_tok, dim))
        out.append((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))
    return out


def doc_metadata(ids):
    """One integer and one text field a doc; the text holds a token that
    only this doc has (its id at ingest)."""
    return [{"year": 1990 + i % 35, "title": f"uid{i} {TITLE_WORDS[i % len(TITLE_WORDS)]} study"}
            for i in ids]


def same_results(got, want, label):
    """Bit-identical result lists (same tensors, same kernel)."""
    if [(r.passage_ids, r.scores) for r in got] != [(r.passage_ids, r.scores) for r in want]:
        raise AssertionError(f"{label}: results differ")


def mutation_phase(device, mk, path, topics, queries):
    """This slice's path at SciFact scale: ingest, in-place appends into the
    pinned bf16 and int8 grids, capacity growth, centroid expansion, FIFO
    eviction and the stale-IVF reroute, on the SciFact index at `path`.
    Returns the two kernels' numbers of the phase."""
    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.filtering import text_search
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, UpdateConfig, delete_with_options,
        search_batch, search_batch_async, update_or_create_with_metadata,
    )
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.index.update import find_outliers, load_buffer, load_cluster_threshold
    from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json, load_npy
    from nextplaid_tpu_torch.utils.errors import UpdateError

    layout = IndexLayout(path)
    params = SearchParameters(top_k=10, stage1_precision="default")
    oracle_params = SearchParameters(top_k=10, mode="exact", stage1_precision="highest")
    n_eval = 64
    n0 = load_json(layout.metadata)["num_documents"]
    t0 = time.perf_counter()
    filtering.create(path, doc_metadata(range(n0)), list(range(n0)))
    text_search.index(path, doc_metadata(range(n0)), list(range(n0)))
    print(f"mutations: metadata + FTS for {n0} docs in {time.perf_counter() - t0:.2f} s", flush=True)

    def reload(dtype=None, capacity=1.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = DeviceIndex.load(path, capacity_factor=capacity, grid_aware_capacity=capacity > 1.0)
        if dtype is not None:
            index = index.with_token_grid(dtype=dtype)
            if index.token_grid is None or index.grid_is_int8 != (dtype == "int8"):
                raise AssertionError(f"the {dtype} grid was not pinned")
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    def ingest(docs, first_id):
        info = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = update_or_create_with_metadata(
            docs, path, IndexConfig(nbits=4), UpdateConfig(),
            metadata=doc_metadata(range(first_id, first_id + len(docs))), info_out=info)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if ids != list(range(first_id, first_id + len(docs))):
            raise AssertionError(f"ingest returned ids {ids[:3]}... for first id {first_id}")
        return info, ms

    def append(index, encoded):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = index.append_batch(*encoded)
        torch.cuda.synchronize()
        if out is None:
            raise AssertionError("append_batch could not append in place")
        return out, 1e3 * (time.perf_counter() - t0)

    def check_same(index, fresh, label, own_doc, own_id):
        """Top-10 of the 320 queries equal a fresh reload's (tie rule), and
        a query of a new doc's own tokens finds it first."""
        got, want = search_batch(index, queries, params), search_batch(fresh, queries, params)
        check_results(got, NUM_QUERIES)
        tol = MUT_RTOL * max(max(abs(x) for x in r.scores) for r in want)
        assert_same_topk(got, want, tol, label)
        hit = search_batch(index, [own_doc[:32]], params)[0]
        if hit.passage_ids[0] != own_id:
            raise AssertionError(f"{label}: doc {own_id}'s own tokens found {hit.passage_ids[:3]}")

    kb, k8 = mk.maxsim_grid_scores, mk.maxsim_grid_scores_int8i
    kb.launches = k8.launches = 0
    t_phase = time.perf_counter()
    served, _ = reload("bf16", MUT_CAPACITY)
    served8, _ = reload("int8", MUT_CAPACITY)
    tight, _ = reload("bf16")
    unpinned = DeviceIndex.load(path, capacity_factor=MUT_CAPACITY)
    g, g8 = served.token_grid, served8.token_grid
    print(f"mutations: served loads with capacity_factor {MUT_CAPACITY} (grid-aware): {n0} docs in "
          f"{served.num_docs_padded} doc rows and {served.codes.shape[0]} token rows (without "
          f"headroom {tight.num_docs_padded} and {tight.codes.shape[0]}); bf16 grid {tuple(g.shape)} = "
          f"{g.numel() * 2 / 2**20:.1f} MiB; int8 grid {tuple(g8.shape)} + scales = "
          f"{(g8.numel() + 2 * served8.token_scales.numel()) / 2**20:.1f} MiB", flush=True)

    next_id = n0
    appended = {}
    for b in range(MUT_BUFFERED_BATCHES):
        docs = new_docs(topics, MUT_BATCH, seed=100 + b)
        old = served
        if b == 0:
            before = search_batch(old, queries[:n_eval], params)
            pending = search_batch_async(old, queries[:n_eval], params)
        info, disk_ms = ingest(docs, next_id)
        if info["mode"] != "buffer":
            raise AssertionError(f"batch {b + 1}: mode {info['mode']}, expected buffer")
        served, app_ms = append(served, info["encoded"])
        fresh, reload_s = reload("bf16")
        check_same(served, fresh, f"batch {b + 1} bf16", docs[0], next_id)
        print(f"mutations [batch {b + 1}, bf16]: mode buffer, {MUT_BATCH} docs "
              f"({int(info['encoded'][2].sum())} tokens); update_or_create_with_metadata "
              f"{disk_ms:.1f} ms, append_batch {app_ms:.2f} ms; yardstick load + with_token_grid "
              f"{reload_s:.3f} s; top-10 of {NUM_QUERIES} queries = the fresh reload's, own-token "
              f"query finds doc {next_id}", flush=True)
        if b == 0:
            # The pre-append object answers for its own docs, enqueued
            # before the in-place append or searched after it, and takes
            # no second append.
            same_results(pending.result(), before, "pre-append object, enqueued before the append")
            same_results(search_batch(old, queries[:n_eval], params), before,
                         "pre-append object, searched after the append")
            try:
                old.append_batch(*info["encoded"])
            except UpdateError:
                pass
            else:
                raise AssertionError("the pre-append object took a second append over its successor's rows")
            served8, app8_ms = append(served8, info["encoded"])
            fresh8, reload8_s = reload("int8")
            check_same(served8, fresh8, "batch 1 int8", docs[0], next_id)
            print(f"mutations [batch 1, int8]: append_batch {app8_ms:.2f} ms; yardstick load + "
                  f"with_token_grid(int8) {reload8_s:.3f} s; top-10 = the fresh reload's", flush=True)
            rows_before = tight.num_docs_padded
            tight, grow_ms = append(tight, info["encoded"])
            if tight.num_docs_padded <= rows_before or tight.token_grid is None or tight.grid_is_int8:
                raise AssertionError("the append without headroom did not grow a bf16 grid")
            check_same(tight, fresh, "batch 1 after growth", docs[0], next_id)
            print(f"mutations [batch 1, capacity_factor 1.0]: append_batch with _grow {grow_ms:.1f} ms "
                  f"({rows_before} -> {tight.num_docs_padded} doc rows, grid "
                  f"{tuple(tight.token_grid.shape)}); top-10 = the fresh reload's", flush=True)
            del tight, fresh8

            # Unpinned: a staged request on the stale IVF is rerouted; then
            # refresh_ivf restores the staged route.
            unp, _ = append(unpinned, info["encoded"])
            oracle = search_batch(DeviceIndex.load(path), queries[:n_eval], oracle_params)
            handler = _Messages()
            log = logging.getLogger("nextplaid_tpu_torch.index.search")
            log.addHandler(handler)
            try:
                p = search_batch_async(unp, queries[:n_eval], SearchParameters(**STAGED_COMMON, **STAGED_POINTS[0][1]))
                rerouted = p.result()
            finally:
                log.removeHandler(handler)
            if p.shapes is not None or not any("IVF is stale" in m for m in handler.messages):
                raise AssertionError("a staged request on a stale IVF was not rerouted")
            r_reroute = recall_at_10(rerouted, oracle)
            if r_reroute < MIN_RECALL:
                raise AssertionError(f"rerouted recall@10 {r_reroute} < {MIN_RECALL}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refreshed = unp.refresh_ivf(path)
            refresh_ms = 1e3 * (time.perf_counter() - t0)
            if refreshed.ivf_stale:
                raise AssertionError("refresh_ivf left the IVF stale")
            recalls = []
            for label, kw, recorded in STAGED_POINTS:
                p = search_batch_async(refreshed, queries[:n_eval], SearchParameters(**STAGED_COMMON, **kw))
                r = recall_at_10(p.result(), oracle)
                if p.shapes is None or r < recorded - RECALL_SLACK:
                    raise AssertionError(f"staged [{label}] after refresh_ivf: recall@10 {r}")
                recalls.append(f"{label} {r:.4f}")
            print(f"mutations [unpinned]: staged request on the stale IVF rerouted to exhaustive "
                  f"search (warning logged), recall@10 {r_reroute:.4f}; refresh_ivf {refresh_ms:.1f} ms; "
                  f"staged recall@10 vs the f32 oracle: {', '.join(recalls)}", flush=True)
            del unp, refreshed, unpinned, oracle
        next_id += MUT_BATCH
    appended["bf16"], appended["int8"] = served, served8

    # Batch 4: the buffer reaches buffer_size, so the update expands the
    # centroids and re-indexes the buffered docs with the new ones.
    docs = new_docs(topics, MUT_BATCH, seed=100 + MUT_BUFFERED_BATCHES)
    k_before = load_json(layout.metadata)["num_partitions"]
    n_out = len(find_outliers(np.concatenate(load_buffer(path) + docs),
                              np.asarray(load_npy(layout.centroids), np.float32),
                              load_cluster_threshold(path) ** 2))
    info, expand_ms = ingest(docs, next_id)
    if info["mode"] != "expand" or "encoded" in info:
        raise AssertionError(f"batch 4: mode {info['mode']}, expected expand without an encoded batch")
    k_after = load_json(layout.metadata)["num_partitions"]
    served, pin_s = reload("bf16", MUT_CAPACITY)
    oracle = search_batch(DeviceIndex.load(path), queries[:n_eval], oracle_params)
    r_expand = recall_at_10(search_batch(served, queries[:n_eval], params), oracle)
    hit = search_batch(served, [docs[-1][:32]], params)[0]
    print(f"mutations [batch 4, expand]: {n_out} outlier tokens of {MUT_BUFFERED_BATCHES * MUT_BATCH} "
          f"buffered + {MUT_BATCH} new docs; centroids {k_before} -> {k_after} (+{k_after - k_before}); "
          f"update {expand_ms / 1e3:.2f} s; reload + pin {pin_s:.3f} s; recall@10 vs the f32 oracle "
          f"{r_expand:.4f}; own-token query finds doc {hit.passage_ids[0]}", flush=True)
    if k_after <= k_before or r_expand < MIN_RECALL or hit.passage_ids[0] != next_id + MUT_BATCH - 1:
        raise AssertionError("centroid expansion: no centroid added, recall or own-doc check failed")

    # FIFO eviction of the oldest docs: survivors shift down, metadata and
    # FTS follow (not a suffix, so FTS is rebuilt).
    n_before = served.num_documents
    t0 = time.perf_counter()
    n_del = delete_with_options(list(range(MUT_EVICT)), path)
    delete_s = time.perf_counter() - t0
    served, pin_s = reload("bf16", MUT_CAPACITY)
    count = filtering.count(path)
    survivor = MUT_EVICT + 50
    fts_ids, _ = text_search.search(path, f"uid{survivor}", 5)
    subset = filtering.where_condition(path, "year < ?", [2000])
    sub_res = search_batch(served, queries[:n_eval], params, subset=subset)
    in_subset = set(subset)
    outside = sum(1 for r in sub_res for i in r.passage_ids if i not in in_subset)
    oracle = search_batch(DeviceIndex.load(path), queries[:n_eval], oracle_params)
    r_delete = recall_at_10(search_batch(served, queries[:n_eval], params), oracle)
    print(f"mutations [evict {MUT_EVICT} oldest]: delete_with_options {delete_s:.2f} s; reload + pin "
          f"{pin_s:.3f} s; {served.num_documents} docs, {count} metadata rows; FTS 'uid{survivor}' -> "
          f"{fts_ids[:1]}; subset search over {len(subset)} docs: {outside} hits outside; recall@10 "
          f"{r_delete:.4f}", flush=True)
    if (n_del != MUT_EVICT or served.num_documents != n_before - MUT_EVICT or count != served.num_documents
            or fts_ids[:1] != [survivor - MUT_EVICT] or outside or not all(r.passage_ids for r in sub_res)
            or r_delete < MIN_RECALL):
        raise AssertionError("eviction: counts, FTS, subset search or recall check failed")

    launches = {"bf16": kb.launches, "int8": k8.launches}
    print(f"mutations: phase {time.perf_counter() - t_phase:.1f} s; kernel launches bf16 "
          f"{launches['bf16']}, int8 {launches['int8']}", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"the mutation phase launched a kernel no time: {launches}")

    # Each kernel against its plain version on the grids the appends wrote.
    q_arr, _ = _pad_queries(queries[:n_eval], served.dim)
    q_dev = torch.from_numpy(q_arr.reshape(-1, served.dim)).to(device)
    tq = q_arr.shape[1]
    a16 = appended["bf16"]
    lens = torch.zeros(a16.token_grid.shape[0], dtype=torch.int32, device=device)
    lens[: a16.num_docs_padded] = a16.doclens
    err16 = check_kernel(kb, mk.maxsim_grid_scores_reference, (q_dev.to(torch.bfloat16), a16.token_grid, lens, tq),
                         f"bf16 on the appended grid {tuple(a16.token_grid.shape)}, {n_eval}q")
    qi8, qs = quantize_queries_int8(q_dev)
    a8 = appended["int8"]
    err8 = check_kernel(k8, mk.maxsim_grid_scores_int8i_reference, (qi8, qs, a8.token_grid, a8.token_scales, tq),
                        f"int8 on the appended grid {tuple(a8.token_grid.shape)}, {n_eval}q")
    return {"bf16": {"mutation_launches": launches["bf16"], "mutation_max_abs_err": err16},
            "int8": {"mutation_launches": launches["int8"], "mutation_max_abs_err": err8}}


# Encoder phase: GTE-ModernColBERT-v1's published widths (its config.json on
# the Hugging Face hub: ModernBERT-base), random weights from seed 0.
GTE_WIDTHS = dict(
    model_type="modernbert", vocab_size=50368, hidden_size=768, num_hidden_layers=22,
    num_attention_heads=12, intermediate_size=1152, local_attention=128,
    global_attn_every_n_layers=3, global_rope_theta=160_000.0, local_rope_theta=10_000.0,
    norm_eps=1e-5, hidden_act="gelu", max_position_embeddings=8192, projection_dim=128,
)
# The BERT family at scripts/profile_encoder.py:35-40's widths
# (answerai-colbert-small-v1: 12 layers, hidden 384, 6 heads, ff 1536).
BERT_WIDTHS = dict(
    model_type="bert", vocab_size=30522, hidden_size=384, num_hidden_layers=12,
    num_attention_heads=6, intermediate_size=1536, max_position_embeddings=512,
    projection_dim=96,
)
ENC_DOCS = 5183
ENC_WORDS = 280
ENC_QUERIES = 320
ENC_QUERY_WORDS = 20
ENC_BATCH = 64
ENC_CHUNK_DOCS = 1024
ENC_INTERRUPT_AT = 3  # the chunk iterator raises when asked for this chunk
ENC_CHECK_DOCS = 16
ENC_BERT_DOCS = 2048
ENC_TOPICS = 1024  # vocabulary topics a document draws most of its words from
# Least per-token cosine of the card's bf16 forward against the CPU's f32 one
# on the same weights: tests/test_torch_encoder.py's bound on the bf16-vs-f32
# gap (BF16_GAP_MIN_COS).
ENC_MIN_COS_BF16 = 0.999
# Quantized against full-precision forward: tests/test_encoder.py:376's bound.
ENC_MIN_COS_INT8 = 0.99
# The attention kernel's check at the rerank cells' shapes
# (benchmark/traffic/rerank32_long_w1.json, rerank32_long_xlmr_w1.json): 32
# documents of log-normal lengths (median 1,024 tokens, sigma 1.0, clipped
# to 64-8,192) and one of 8,192; heads of 64, bf16. Each case is a layer
# kind: its heads, half window and RoPE theta; GTE-ModernColBERT-v1's global
# and local layers at 12 heads, jina-colbert-v2's global layer at 16. Held
# at ENC_MIN_COS_BF16.
ATTN_DOCS = 32
ATTN_HEAD_DIM = 64
ATTN_LAYERS = (("global", 12, None, 160_000.0), ("local", 12, 64, 10_000.0),
               ("jina", 16, None, 20_000.0))
# jina-colbert-v2's published widths (Jina's rotary XLM-RoBERTa-large:
# benchmark/encoders/jina_colbert_v2_long.json, whose rotary_emb_base is
# assumed there), random weights from seed 0, run through
# Colbert(model_dir=...) on one rerank request's documents.
JINA_WIDTHS = dict(
    model_type="xlm-roberta", vocab_size=250002, hidden_size=1024, num_hidden_layers=24,
    num_attention_heads=16, intermediate_size=4096, max_position_embeddings=8194,
    type_vocab_size=1, layer_norm_eps=1e-5, hidden_act="gelu",
    position_embedding_type="rotary", rotary_emb_base=20_000.0,
)
JINA_DIM = 128


class WhitespaceTokenizer:
    """Pure-Python whitespace tokenizer over a synthetic vocabulary of
    `vocab_size` entries: the special tokens, two punctuation marks and the
    words "w0", "w1", ...; unknown words map to [UNK]. `encode` adds [CLS]
    and [SEP] when asked (the card has no `tokenizers`)."""

    SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]", ".", ",")

    def __init__(self, vocab_size):
        words = list(self.SPECIAL) + [f"w{i}" for i in range(vocab_size - len(self.SPECIAL))]
        self.vocab = {w: i for i, w in enumerate(words)}
        self.n_words = vocab_size - len(self.SPECIAL)

    def token_to_id(self, token):
        return self.vocab.get(token)

    def encode(self, text, add_special_tokens=True):
        unk = self.vocab["[UNK]"]
        ids = [self.vocab.get(w, unk) for w in text.split()]
        if add_special_tokens:
            return [self.vocab["[CLS]"], *ids, self.vocab["[SEP]"]]
        return ids


def colbert_config(tok, embedding_dim):
    from nextplaid_tpu_torch.encoder import ColbertConfig

    return ColbertConfig(
        query_prefix="[Q] ", document_prefix="[D] ", query_length=32, document_length=300,
        embedding_dim=embedding_dim, mask_token_id=tok.vocab["[MASK]"],
        pad_token_id=tok.vocab["[PAD]"], skiplist_words=[".", ","],
        uses_token_type_ids=False,
    )


def make_texts(n_docs, n_words, vocab_words, seed=0, n_topics=ENC_TOPICS):
    """`n_docs` documents of `n_words` words: each draws 3/4 of its words
    from its topic's 256 words and the rest from the whole vocabulary under
    a Zipf law (so common words recur everywhere), with a punctuation mark
    every 20 words."""
    rng = np.random.default_rng(seed)
    topic_words = rng.integers(0, vocab_words, (n_topics, 256))
    zipf = 1.0 / np.arange(1, vocab_words + 1)
    zipf /= zipf.sum()
    texts = []
    for t in rng.integers(0, n_topics, n_docs):
        from_topic = rng.random(n_words) < 0.75
        ids = np.where(from_topic, topic_words[t, rng.integers(0, 256, n_words)],
                       rng.choice(vocab_words, n_words, p=zipf))
        words = [f"w{i}" for i in ids]
        for j in range(19, n_words, 20):
            words[j] += " ."
        texts.append(" ".join(words))
    return texts


def excerpt_queries(texts, n, n_words, seed=1):
    """`n` queries of `n_words` consecutive words, each from one document.
    Returns (queries, source doc ids)."""
    rng = np.random.default_rng(seed)
    sources = rng.choice(len(texts), n, replace=False)
    out = []
    for d in sources:
        words = texts[d].split()
        s = int(rng.integers(0, len(words) - n_words))
        out.append(" ".join(words[s : s + n_words]))
    return out, sources


def per_token_cos(a, b, valid=None):
    """Least cosine between rows of [..., dim] a and b (where `valid`)."""
    a, b = a.double(), b.double()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-12)
    return float((cos if valid is None else cos[valid]).min())


def packed_batch(ids, attn, device):
    """A padded batch's live tokens (each row a prefix of ones, as
    `Colbert._prepare` pads them) as `ColbertModel.forward_packed` takes
    them: ids [N], positions [N] and cu_seqlens [B + 1] int32 on `device`."""
    from nextplaid_tpu_torch.encoder.model import packed_positions

    lens = attn.sum(1).astype(np.int64)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return (torch.from_numpy(ids[attn.astype(bool)].astype(np.int64)).to(device),
            torch.from_numpy(packed_positions(lens)).to(device), torch.from_numpy(cu).to(device))


def forward_ms(model, packed, reps=5):
    with torch.inference_mode():
        return time_ms(lambda: model.forward_packed(*packed), reps)


def attention_lengths(seed=7):
    """A rerank request's document lengths as the cell draws them, and one
    of 8,192 tokens, ascending as the encoder packs them."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(1024 * np.exp(rng.standard_normal(ATTN_DOCS))), 64, 8192)
    return np.sort(np.append(lens.astype(np.int64), 8192))


def attention_check(device):
    """ops/attention.py's kernel against its plain version
    (`varlen_attention_reference`) on one packed forward at the rerank
    cells' shapes (ATTN_*), each layer kind of ATTN_LAYERS, RoPE on, with
    the tile table the encoder passes: least cosine per token and head at
    ENC_MIN_COS_BF16, and max |difference|. The bound must catch a planted
    fault of each kind: on a global layer the longest document's last key
    tile skipped (the kernel over that document less its last BLOCK_N
    tokens, compared on the rows it computed), on a local one a band one
    narrower (half window 63 against 64). Both versions timed (CUDA events)
    beside the bound, max(operations at 989 TFLOP/s, q, k, v and output
    bytes at the HBM rate). Sets the launch counter to 0 first; returns the
    kernel's numbers for the kernels line: ModernBERT's global layer's
    unprefixed, the local layer's as `local_*`, jina-colbert-v2's as
    `jina_*`."""
    from nextplaid_tpu_torch.encoder.model import _rope_tables, packed_positions
    from nextplaid_tpu_torch.ops import attention as A

    A.varlen_attention.launches = 0
    lens = attention_lengths()
    n, d = int(lens.sum()), ATTN_HEAD_DIM
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=device)
    pos = torch.from_numpy(packed_positions(lens)).to(device)
    tiles = A.tile_table(cu, n)
    scale = 1.0 / math.sqrt(d)
    cu_cut = cu.clone()
    cu_cut[-1] -= A.BLOCK_N
    tiles_cut = A.tile_table(cu_cut, n)
    cos = lambda a, b: per_token_cos(a.reshape(-1, d), b.reshape(-1, d))  # noqa: E731
    out = {}
    for kind, h, half_window, theta in ATTN_LAYERS:
        gen = torch.Generator(device=device).manual_seed(3)
        q, k, v = (torch.randn(n, h, d, device=device, generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        rope = _rope_tables(pos, d, theta)
        got = A.varlen_attention(q, k, v, cu, half_window, scale, rope=rope, tiles=tiles)
        want = A.varlen_attention_reference(q, k, v, cu, half_window, scale, rope=rope)
        least = cos(got, want)
        max_err = float((got.float() - want.float()).abs().max())
        if half_window is None:
            fault = "the longest document's last key tile skipped"
            bad = A.varlen_attention(q, k, v, cu_cut, None, scale, rope=rope, tiles=tiles_cut)
            fault_cos = cos(bad[: n - A.BLOCK_N], want[: n - A.BLOCK_N])
        else:
            fault = f"a band of half window {half_window - 1}"
            bad = A.varlen_attention(q, k, v, cu, half_window - 1, scale, rope=rope, tiles=tiles)
            fault_cos = cos(bad, want)
        del want, bad
        if not least >= ENC_MIN_COS_BF16:
            raise AssertionError(f"attention kernel [{kind}] against its plain version: least "
                                 f"cosine {least} < {ENC_MIN_COS_BF16}")
        if not fault_cos < ENC_MIN_COS_BF16:
            raise AssertionError(f"attention check [{kind}]: {fault} reads least cosine "
                                 f"{fault_cos}, within the bound {ENC_MIN_COS_BF16}")
        kernel_ms = time_ms(lambda: A.varlen_attention(q, k, v, cu, half_window, scale,
                                                       rope=rope, tiles=tiles), 20)
        plain_ms = time_ms(lambda: A.varlen_attention_reference(q, k, v, cu, half_window, scale,
                                                                rope=rope), 2)
        del q, k, v
        w = half_window
        pairs = int((lens * lens if w is None else
                     np.where(lens <= w + 1, lens * lens, lens * (2 * w + 1) - w * (w + 1))).sum())
        ops_ms = 1e3 * 4 * h * d * pairs / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * 4 * 2 * n * h * d / PEAK_HBM_BYTES
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"attention kernel [{kind}, rerank shapes: {len(lens)} documents, {n} tokens, "
              f"{h} x {d} heads, RoPE theta {theta:g}]: least cosine {least:.6f} (bound "
              f"{ENC_MIN_COS_BF16}), max abs {max_err:.3g}; planted fault ({fault}) least cosine "
              f"{fault_cos:.6f}; kernel {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by}; {100 * bound_ms / kernel_ms:.1f}% of it)",
              flush=True)
        out[kind] = {"least_cos": least, "max_abs_err": max_err, "fault_cos": fault_cos,
                     "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
    torch.cuda.empty_cache()
    g, loc, jina = out["global"], out["local"], out["jina"]
    return {"max_abs_err": max(c["max_abs_err"] for c in out.values()), "ms": g["ms"],
            "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "least_cos": g["least_cos"], "fault_skipped_tile_cos": g["fault_cos"],
            "local_least_cos": loc["least_cos"], "local_max_abs_err": loc["max_abs_err"],
            "fault_narrow_band_cos": loc["fault_cos"], "local_ms": loc["ms"],
            "local_plain_ms": loc["plain_ms"], "local_bound_ms": loc["bound_ms"],
            "local_bound_by": loc["bound_by"], "jina_least_cos": jina["least_cos"],
            "jina_max_abs_err": jina["max_abs_err"],
            "fault_jina_skipped_tile_cos": jina["fault_cos"], "jina_ms": jina["ms"],
            "jina_plain_ms": jina["plain_ms"], "jina_bound_ms": jina["bound_ms"],
            "jina_bound_by": jina["bound_by"], "tokens": n, "documents": len(lens),
            "check_launches": A.varlen_attention.launches}


def jina_model_dir(path, widths=JINA_WIDTHS, dim=JINA_DIM, device="cpu", seed=0):
    """A model directory `Colbert(model_dir=...)` loads for the rotary
    XLM-RoBERTa family: config.json (`widths`) and model.safetensors by the
    names of Jina's flash implementation under `roberta.`, the projection
    [dim, hidden] as `linear.weight`. Random float32 weights from `seed`,
    drawn on `device`: linear layers normal with variance 1/fan_in, biases
    0.1 normal, LayerNorm scales 1 + 0.1 normal, embeddings standard
    normal."""
    from safetensors.torch import save_file

    h, ff = widths["hidden_size"], widths["intermediate_size"]
    shapes = {"embeddings.word_embeddings.weight": (widths["vocab_size"], h),
              "embeddings.token_type_embeddings.weight": (widths["type_vocab_size"], h),
              "emb_ln.weight": (h,), "emb_ln.bias": (h,)}
    for i in range(widths["num_hidden_layers"]):
        b = f"encoder.layers.{i}."
        for name, shape in (("mixer.Wqkv", (3 * h, h)), ("mixer.out_proj", (h, h)),
                            ("mlp.fc1", (ff, h)), ("mlp.fc2", (h, ff))):
            shapes[b + name + ".weight"], shapes[b + name + ".bias"] = shape, shape[:1]
        for norm in ("norm1", "norm2"):
            shapes[b + norm + ".weight"] = shapes[b + norm + ".bias"] = (h,)
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = {}
    for name, shape in shapes.items():
        w = torch.randn(shape, generator=gen, device=device)
        if len(shape) == 1:  # a bias, or a LayerNorm's scale (".weight") or bias
            w = 0.1 * w + (1.0 if name.endswith(".weight") else 0.0)
        elif "embeddings." not in name:
            w /= math.sqrt(shape[1])
        weights["roberta." + name] = w.cpu()
    weights["linear.weight"] = (torch.randn((dim, h), generator=gen, device=device)
                                / math.sqrt(h)).cpu()
    os.makedirs(path, exist_ok=True)
    save_file(weights, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(widths, f)
    return path


def jina_texts(lens, n_words, seed=5):
    """Texts of "w<i>" words, a "." every 20th, that tokenize (with [CLS],
    the document marker and [SEP]) to rows of `lens` tokens."""
    rng = np.random.default_rng(seed)
    texts = []
    for n in lens:
        words = [f"w{i}" for i in rng.integers(0, n_words, int(n) - 3)]
        texts.append(" ".join(w if j % 20 != 19 else "." for j, w in enumerate(words)))
    return texts


def jina_check(device, widths=JINA_WIDTHS, dim=JINA_DIM, work_dir=WORK_DIR):
    """jina-colbert-v2 (the rotary, post-LN BERT family) on its served path:
    a model directory at `widths` loaded by `Colbert(model_dir=...)`, one
    rerank request's documents (`attention_lengths`, bf16) through
    `encode_documents` with tracing on and the attention kernel's launch
    counter set to 0 just before. The launches must be one a layer of each
    packed forward and equal the forwards' `encode.attn_layers_global`,
    every pair global (`encode.attn_pairs_global` = layers x sum L^2,
    `encode.attn_pairs_local` 0), with `encode.prepare` spans and, on the
    card, an `encode.forward` span a forward; each document's embeddings
    (skiplist rows dropped) against the plain float32 reference
    (tests/jina_colbert_reference.py) on `device` at ENC_MIN_COS_BF16.
    Returns its numbers for the kernels line."""
    from nextplaid_tpu_torch.encoder import Colbert
    from nextplaid_tpu_torch.ops import attention as A
    from nextplaid_tpu_torch.utils import trace

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from jina_colbert_reference import JinaColbertReference

    path = jina_model_dir(os.path.join(work_dir, "jina"), widths, dim, device)
    tok = WhitespaceTokenizer(widths["vocab_size"])
    lens = attention_lengths()
    texts = jina_texts(lens, tok.n_words)
    enc = Colbert(path, config=colbert_config(tok, dim), tokenizer=tok, batch_size=ATTN_DOCS,
                  document_length=int(lens.max()), device=device)
    rows = enc._rows(texts, is_query=False)
    before = A.varlen_attention.launches
    enc.encode_documents(texts[:2])  # warm-up
    warm_launches = A.varlen_attention.launches - before
    layers = widths["num_hidden_layers"]
    A.varlen_attention.launches = 0
    with trace.recording(), trace.batch_scope() as batch:
        t0 = time.perf_counter()
        embs = enc.encode_documents(texts)
        encode_s = time.perf_counter() - t0
        launches = A.varlen_attention.launches
        recs = [r for r in trace.records() if r.batch == batch]
    counts = {}
    for r in recs:
        if r.kind == "count":
            counts.setdefault(r.name, []).append(r.value)
    forwards = len(counts.get("encode.attn_layers_global", []))
    forward_ms = [r.value for r in recs if r.kind == "device" and r.name == "encode.forward"]
    prepared = any(r.kind == "span" and r.name == "encode.prepare" for r in recs)
    if (forwards == 0 or launches != layers * forwards
            or sum(counts["encode.attn_layers_global"]) != launches):
        raise AssertionError(f"jina-colbert-v2: {launches} attention launches in {forwards} "
                             f"packed forwards of {layers} layers, encode.attn_layers_global "
                             f"{counts.get('encode.attn_layers_global')}")
    row_lens = np.asarray([len(r) for r in rows], np.int64)
    if (list(row_lens) != list(lens) or sum(counts["encode.attn_pairs_global"])
            != layers * int((row_lens * row_lens).sum())
            or any(counts["encode.attn_pairs_local"]) or not prepared
            or len(forward_ms) != (forwards if torch.device(device).type == "cuda" else 0)):
        raise AssertionError(f"jina-colbert-v2: rows of {row_lens.tolist()} tokens, counters "
                             f"{counts}, {len(forward_ms)} encode.forward device spans, "
                             f"encode.prepare recorded: {prepared}")
    skip = torch.tensor(sorted(enc.skiplist_ids))
    del enc
    gc.collect()
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    ref = JinaColbertReference.from_dir(path, device)
    try:
        least = min(per_token_cos(torch.from_numpy(e),
                                  ref.encode(r)[~torch.isin(torch.tensor(r), skip)].cpu())
                    for r, e in zip(rows, embs))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    print(f"encoder [jina-colbert-v2 widths, {layers} rotary post-LN layers, hidden "
          f"{widths['hidden_size']}, {widths['num_attention_heads']} heads, random weights, "
          f"Colbert(model_dir=...)]: {len(rows)} documents, {int(row_lens.sum())} tokens in "
          f"{forwards} packed forward(s), {1e3 * encode_s:.1f} ms (encode.forward "
          f"{sum(forward_ms):.1f} ms on the card); attention kernel launches "
          f"{launches} (encode.attn_layers_global {counts['encode.attn_layers_global']}); least "
          f"per-token cosine card bf16 vs plain f32 {least:.6f} (bound {ENC_MIN_COS_BF16})",
          flush=True)
    if not least >= ENC_MIN_COS_BF16:
        raise AssertionError(f"jina-colbert-v2 on the card against its plain version: least "
                             f"cosine {least} < {ENC_MIN_COS_BF16}")
    return {"jina_launches": warm_launches + launches, "jina_forward_launches": launches,
            "jina_forwards": forwards,
            "jina_encoder_least_cos": least, "jina_encode_ms": 1e3 * encode_s,
            "jina_forward_ms": sum(forward_ms)}


def encoder_phase(device, mk, n_docs=ENC_DOCS, widths=GTE_WIDTHS, bert_widths=BERT_WIDTHS,
                  n_queries=ENC_QUERIES, chunk_docs=ENC_CHUNK_DOCS, bert_docs=ENC_BERT_DOCS):
    """Text to a searchable index on the card: the ColBERT encoder at
    GTE-ModernColBERT-v1's widths (the card's bf16 forward against the
    CPU's f32 one; the quantized forward against full precision, in f32
    on the card and as shipped, bf16 + int8, against the CPU's f32), the
    corpus encoded, a streamed build interrupted and resumed (byte-equal to
    an uninterrupted one, written chunks skipped, another nbits refused),
    load + bf16 pin, encoded queries searched through the bf16 kernel with
    recall@10 against the f32 oracle; then the BERT family's throughput;
    then jina-colbert-v2 through `Colbert(model_dir=...)` (`jina_check`).
    Returns the bf16 kernel's launches in the phase and its largest
    difference from the plain version on the encoded grid, and the
    attention kernel's numbers (`attention_check`'s and `jina_check`'s,
    with the phase's launches)."""
    from nextplaid_tpu_torch.encoder import BackboneConfig, Colbert, ColbertModel, init_random_params
    from nextplaid_tpu_torch.encoder.model import quantize_dense_params
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index_streamed, search_batch,
    )
    from nextplaid_tpu_torch.index.build import DeviceChunk
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.ops.attention import varlen_attention
    from nextplaid_tpu_torch.utils.errors import StorageError

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    try:
        attention = attention_check(device)
        bcfg = BackboneConfig(**widths)
        tok = WhitespaceTokenizer(bcfg.vocab_size)
        t0 = time.perf_counter()
        params = init_random_params(bcfg, seed=0)
        init_s = time.perf_counter() - t0
        enc = Colbert(config=colbert_config(tok, bcfg.projection_dim), backbone_config=bcfg,
                      tokenizer=tok, params=params, batch_size=ENC_BATCH, device=device)
        texts = make_texts(n_docs, ENC_WORDS, tok.n_words)

        # The card's packed bf16 forward against the CPU's padded f32 one
        # (the JAX chain), same weights, on the live tokens.
        ids_np, attn_np, _, _ = enc._prepare(texts[:ENC_CHECK_DOCS], is_query=False)
        ids, attn = torch.from_numpy(ids_np), torch.from_numpy(attn_np)
        packed = packed_batch(ids_np, attn_np, device)
        cpu = ColbertModel(bcfg, compute_dtype=torch.float32, device="cpu")
        cpu.load_state_dict(params)
        with torch.inference_mode():
            want = cpu(ids, attn)[attn.bool()]
            attn_before = varlen_attention.launches
            got = enc.model.forward_packed(*packed).cpu()
            attn_launches = varlen_attention.launches - attn_before
        del cpu
        if attn_launches != bcfg.num_hidden_layers:
            raise AssertionError(f"the card's forward launched the attention kernel "
                                 f"{attn_launches} times, not once a layer "
                                 f"({bcfg.num_hidden_layers})")
        cos_bf16 = per_token_cos(got, want)
        # The quantized forward against the full-precision one, both f32 on
        # the card (tests/test_encoder.py:376's comparison).
        full = ColbertModel(bcfg, compute_dtype=torch.float32, device=device)
        full.load_state_dict(params)
        quant = ColbertModel(bcfg, compute_dtype=torch.float32, quantized=True, device=device)
        quant.load_state_dict(quantize_dense_params(params))
        with torch.inference_mode():
            cos_int8 = per_token_cos(quant.forward_packed(*packed).cpu(),
                                     full.forward_packed(*packed).cpu())
        del full, quant
        # The quantized model that is timed and shipped (bf16 compute, int8
        # dense products) against the CPU's f32 full-precision forward.
        qenc = Colbert(config=colbert_config(tok, bcfg.projection_dim), backbone_config=bcfg,
                       tokenizer=tok, params=params, batch_size=ENC_BATCH, quantized=True,
                       device=device)
        with torch.inference_mode():
            cos_shipped = per_token_cos(qenc.model.forward_packed(*packed).cpu(), want)
        print(f"encoder [GTE-ModernColBERT-v1 widths, {bcfg.num_hidden_layers} layers, hidden "
              f"{bcfg.hidden_size}, random weights]: init {init_s:.2f} s; {ENC_CHECK_DOCS} docs x "
              f"{ids.shape[1]} tokens, attention kernel launches {attn_launches} a forward, "
              f"least per-token cosine card bf16 vs CPU f32 "
              f"{cos_bf16:.6f} (bound {ENC_MIN_COS_BF16}), int8 vs f32 on the card "
              f"{cos_int8:.6f}, card bf16 + int8 vs CPU f32 {cos_shipped:.6f} (bound "
              f"{ENC_MIN_COS_INT8} each)", flush=True)
        if (cos_bf16 < ENC_MIN_COS_BF16 or cos_int8 < ENC_MIN_COS_INT8
                or cos_shipped < ENC_MIN_COS_INT8):
            raise AssertionError(f"encoder forward cosines {cos_bf16}, {cos_int8}, "
                                 f"{cos_shipped} below bounds")

        # The forward alone at a full batch, by CUDA events; then the corpus.
        ids_np, attn_np, _, _ = enc._prepare(texts[:ENC_BATCH], is_query=False)
        packed_b = packed_batch(ids_np, attn_np, device)
        fwd_ms = forward_ms(enc.model, packed_b)
        fwd_q_ms = forward_ms(qenc.model, packed_b)
        del params
        enc.encode_documents(texts[: 2 * ENC_BATCH])  # warm-up
        torch.cuda.synchronize()
        attn_before = varlen_attention.launches
        t0 = time.perf_counter()
        embs = enc.encode_documents(texts)
        encode_s = time.perf_counter() - t0
        corpus_launches = varlen_attention.launches - attn_before
        if corpus_launches == 0 or corpus_launches % bcfg.num_hidden_layers:
            raise AssertionError(f"encoding the corpus launched the attention kernel "
                                 f"{corpus_launches} times, not once a layer of each forward")
        n_batches = corpus_launches // bcfg.num_hidden_layers  # packed forwards
        host_share = max(0.0, 1.0 - n_batches * fwd_ms / (1e3 * encode_s))
        n_sub = min(n_docs, 16 * ENC_BATCH)
        qenc.encode_documents(texts[: 2 * ENC_BATCH])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_embs = qenc.encode_documents(texts[:n_sub])
        q_rate = n_sub / (time.perf_counter() - t0)
        del qenc
        doclens = np.asarray([e.shape[0] for e in embs], np.int64)
        total = int(doclens.sum())
        if (any(e.shape[1] != bcfg.projection_dim or not np.isfinite(e).all() for e in embs)
                or len(q_embs) != n_sub):
            raise AssertionError("encoded documents are not finite [tokens, dim] arrays")
        print(f"encode: {n_docs} docs of {ENC_WORDS} words, {total} tokens at batch {ENC_BATCH}: "
              f"{encode_s:.2f} s, {n_docs / encode_s:.1f} docs/s, {total / encode_s:.0f} tokens/s; "
              f"packed forward {fwd_ms:.3f} ms a batch of {ENC_BATCH} documents, "
              f"{packed_b[0].numel()} tokens (CUDA events), "
              f"host share of the wall {100 * host_share:.1f}%; quantized forward {fwd_q_ms:.3f} ms "
              f"a batch, {q_rate:.1f} docs/s over {n_sub} docs (bf16 "
              f"{n_docs / encode_s:.1f}); attention kernel launches {corpus_launches} "
              f"({corpus_launches // bcfg.num_hidden_layers} packed forwards)", flush=True)
        del packed_b

        # The streamed build, uninterrupted; then interrupted and resumed.
        bounds = np.concatenate([[0], np.cumsum(doclens)])
        sample = torch.from_numpy(np.concatenate(embs)).to(device)
        cfg = IndexConfig(nbits=4, seed=42)

        class Interrupted(RuntimeError):
            pass

        def chunks(stop=None):
            for i, s in enumerate(range(0, n_docs, chunk_docs)):
                if i == stop:
                    raise Interrupted(f"chunk {i}")
                e = min(s + chunk_docs, n_docs)
                yield DeviceChunk(tokens=sample[int(bounds[s]) : int(bounds[e])],
                                  doclens=doclens[s:e])

        def build(path, stop=None, resume=False, config=cfg):
            return create_index_streamed(chunks(stop), path, config, sample_tokens=sample,
                                         est_total_tokens=total, resume=resume, device=device)

        full_path = os.path.join(WORK_DIR, "encoded")
        res_path = os.path.join(WORK_DIR, "encoded_resumed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = build(full_path)
        build_s = time.perf_counter() - t0
        try:
            build(res_path, stop=ENC_INTERRUPT_AT)
            raise AssertionError("the interrupted build did not stop")
        except Interrupted:
            pass
        written = sorted(n for n in os.listdir(res_path) if n.split(".")[0].isdigit()
                         or n.startswith("doclens."))
        before = {n: os.stat(os.path.join(res_path, n)).st_mtime_ns for n in written}
        if len(written) != 4 * ENC_INTERRUPT_AT:
            raise AssertionError(f"the interrupted build left {written}")
        t0 = time.perf_counter()
        build(res_path, resume=True)
        resume_s = time.perf_counter() - t0
        rewritten = [n for n in written
                     if os.stat(os.path.join(res_path, n)).st_mtime_ns != before[n]]
        names = sorted(n for n in os.listdir(full_path) if not n.startswith(".nextplaid"))
        if names != sorted(n for n in os.listdir(res_path) if not n.startswith(".nextplaid")):
            raise AssertionError("the resumed build wrote other files than the uninterrupted one")
        differ = [n for n in names if not filecmp.cmp(os.path.join(full_path, n),
                                                      os.path.join(res_path, n), shallow=False)]
        if differ or rewritten:
            raise AssertionError(f"resume: files differ {differ}, chunks rewritten {rewritten}")
        try:
            build(res_path, resume=True, config=IndexConfig(nbits=2, seed=42))
            raise AssertionError("a resume with another nbits was not refused")
        except StorageError:
            pass
        del sample
        print(f"build: create_index_streamed {meta.num_documents} docs, {meta.num_embeddings} "
              f"tokens, K {meta.num_partitions}, nbits 4, chunks of {chunk_docs} docs: "
              f"{build_s:.2f} s; interrupted at chunk {ENC_INTERRUPT_AT} and resumed in "
              f"{resume_s:.2f} s: {len(names)} files byte-equal to the uninterrupted build, "
              f"{len(written)} chunk files skipped (mtime unchanged); nbits 2 resume refused",
              flush=True)

        # Load + pin, encoded queries through the bf16 kernel.
        # The load merges the 6 chunks natively and stores the merge cache
        # (as the default "auto" does at this size), stated explicitly.
        t0 = time.perf_counter()
        with merge_cache_flag("1"):
            unpinned = DeviceIndex.load(full_path, device=device)
        index = unpinned.with_token_grid(dtype="bf16")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        q_texts, sources = excerpt_queries(texts, n_queries, ENC_QUERY_WORDS)
        t0 = time.perf_counter()
        queries = enc.encode_queries(q_texts)
        query_s = time.perf_counter() - t0
        params = SearchParameters(top_k=10, stage1_precision="default")
        search_batch(index, queries[:ENC_BATCH], params)  # warm-up
        kernel = mk.maxsim_grid_scores
        kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = search_batch(index, queries, params)
        search_s = time.perf_counter() - t0
        launches = kernel.launches
        if launches == 0:
            raise AssertionError("the encoder phase's search launched the bf16 kernel no time")
        check_results(results, n_queries)
        oracle = search_batch(unpinned, queries, SearchParameters(
            top_k=10, mode="exact", stage1_precision="highest"))
        recall = recall_at_10(results, oracle)
        self_hit = float(np.mean([s in r.passage_ids for s, r in zip(sources, results)]))
        print(f"search: load (native merge + merge cache store) + bf16 pin {load_s:.2f} s; "
              f"{n_queries} queries of "
              f"{ENC_QUERY_WORDS} words encoded in {1e3 * query_s:.1f} ms, searched in "
              f"{1e3 * search_s:.1f} ms; recall@10 vs the f32 oracle {recall:.4f} (floor "
              f"{MIN_RECALL}); source doc in the top 10 {self_hit:.4f} (random weights: "
              f"printed, not held); bf16 kernel launches {launches}", flush=True)
        if recall < MIN_RECALL:
            raise AssertionError(f"encoded corpus recall@10 {recall} < {MIN_RECALL}")
        # The kernel against its plain version on the encoded grid (the
        # encoder's Td and doclens) and the padded encoded queries.
        q_arr, _ = _pad_queries(queries, index.dim)
        q_dev = torch.from_numpy(q_arr.reshape(-1, index.dim)).to(device, torch.bfloat16)
        lens = torch.zeros(index.token_grid.shape[0], dtype=torch.int32, device=device)
        lens[: index.num_docs_padded] = index.doclens
        max_err = check_kernel(kernel, mk.maxsim_grid_scores_reference,
                               (q_dev, index.token_grid, lens, q_arr.shape[1]),
                               f"bf16 on the encoded grid {tuple(index.token_grid.shape)}, "
                               f"{n_queries}q")
        del index, unpinned, enc, embs, q_dev
        gc.collect()
        torch.cuda.empty_cache()

        # The BERT family's throughput.
        bert = BackboneConfig(**bert_widths)
        btok = WhitespaceTokenizer(bert.vocab_size)
        benc = Colbert(config=colbert_config(btok, bert.projection_dim), backbone_config=bert,
                       tokenizer=btok, params=init_random_params(bert, seed=0),
                       batch_size=ENC_BATCH, device=device)
        btexts = make_texts(bert_docs, ENC_WORDS, btok.n_words, seed=2)
        benc.encode_documents(btexts[: 2 * ENC_BATCH])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bembs = benc.encode_documents(btexts)
        bert_s = time.perf_counter() - t0
        if any(not np.isfinite(e).all() for e in bembs):
            raise AssertionError("BERT-family embeddings are not finite")
        print(f"encoder [BERT, {bert.num_hidden_layers} layers, hidden {bert.hidden_size}]: "
              f"{bert_docs} docs in {bert_s:.2f} s, {bert_docs / bert_s:.1f} docs/s; the phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        del benc
        gc.collect()
        torch.cuda.empty_cache()

        # jina-colbert-v2, the rotary post-LN BERT family, packed.
        launches_so_far = varlen_attention.launches
        jina = jina_check(device)
        attention.update(launches=launches_so_far + jina["jina_launches"],
                         forward_launches=attn_launches, corpus_launches=corpus_launches, **jina)
        return {"encoder_launches": launches, "encoder_max_abs_err": max_err}, attention
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


# Service phase: the REST server (nextplaid_tpu_torch.api) on the SciFact
# index with metadata + FTS, the encoder at GTE-ModernColBERT-v1's widths,
# driven over HTTP by the port's SDK.
SERVICE_DIR = os.path.join(ROOT, "build", "chip_smoke_service")
SERVICE_SRC = os.path.join(ROOT, "build", "chip_smoke_scifact")  # scifact_phases' index, kept
SVC_CLIENTS = 8  # concurrent clients of the 64-query requests
SVC_REQUEST_QUERIES = 64
SVC_PASSES = 3
SVC_SINGLE_CLIENTS = 16  # concurrent clients of the single-query requests
SVC_FILTER = ("year <= ?", [1993])  # doc_metadata's year 1990 + i % 35: 4 in 35 docs
SVC_ALPHA = 0.75
SVC_TEXT_QUERIES = 64
SVC_QUERY_WORDS = 20
SVC_ENCODE_REQUESTS = 3  # of 64 documents (MAX_BATCH_TEXTS) each
SVC_ENCODE_WORDS = 300
SVC_RERANK_DOCS = 32
SVC_INGEST_BATCHES = 3  # of MUT_BATCH docs: 96 buffered docs stay below buffer_size 100
SVC_SIGTERM_S = 10
SVC_STAGE_REPS = 20  # runs of each stage of one request, split by stage
# HTTP top-10 vs in-process search_batch: the same kernel on the same grid,
# other batch compositions (launch plans); scores within this fraction.
SVC_RTOL = 1e-4


def http_results(body):
    """A /search response's results as objects with passage_ids and scores."""
    import types

    return [types.SimpleNamespace(passage_ids=r["document_ids"], scores=r["scores"],
                                  metadata=r["metadata"]) for r in body["results"]]


def kernel_busy_ms(intervals):
    """Union length (ms) of [start, end] intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


@contextlib.contextmanager
def timed_kernel_launches(mk):
    """Record CUDA events around every bf16 kernel launch; yields a list that
    receives the (start, end) ms of each launch's window after the block,
    relative to an event recorded before it."""
    real, events, windows = mk._launch, [], []
    origin = torch.cuda.Event(enable_timing=True)
    origin.record()

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        events.append((start, end))
        return out

    mk._launch = timed
    try:
        yield windows
    finally:
        mk._launch = real
        torch.cuda.synchronize()
        windows.extend((origin.elapsed_time(s), origin.elapsed_time(e)) for s, e in events)


def run_clients(n_clients, jobs, url):
    """Run `jobs` (callables taking a client) on `n_clients` threads, each
    with its own SDK client; returns (results in job order, wall s,
    per-job latencies s)."""
    from concurrent.futures import ThreadPoolExecutor
    import threading

    from nextplaid_tpu_torch.client import NextPlaidClient

    local = threading.local()

    def run(job):
        if not hasattr(local, "client"):
            local.client = NextPlaidClient(url, timeout=600)
        t0 = time.perf_counter()
        out = job(local.client)
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(n_clients) as pool:
        done = list(pool.map(run, jobs))
    wall = time.perf_counter() - t0
    return [d[0] for d in done], wall, [d[1] for d in done]


def median_ms(fn, reps):
    """Median wall ms of `fn()` over `reps` runs, each ended by a sync."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def request_stages(client, index, path, queries, reps=SVC_STAGE_REPS):
    """One /search request of `queries` (base64 f32) split by stage, each
    timed alone on this thread with the server's own functions on the
    previous stage's output: the client's payload, the server's parse,
    `search_batch`, the results' formatting, the metadata attach, the
    response's and the client's JSON. Returns {stage: median ms}, the same
    request's median ms over HTTP from one sequential client, and the
    request's and the response's bytes."""
    from nextplaid_tpu_torch.api import models as dto
    from nextplaid_tpu_torch.api.server import _attach_metadata, _search_params
    from nextplaid_tpu_torch.client.client import _doc_payload
    from nextplaid_tpu_torch.index import search_batch

    def payload():
        return json.dumps({"queries": [_doc_payload(q) for q in queries],
                           "params": {"top_k": 10}})

    body = payload()
    parsed = json.loads(body)
    req = dto.SearchRequest(**parsed)
    arrays = [q.to_array() for q in req.queries]
    params = _search_params(req.params)
    results = search_batch(index, arrays, params)

    def fmt():
        return [{"query_id": i, "document_ids": list(r.passage_ids),
                 "scores": [float(x) for x in r.scores]} for i, r in enumerate(results)]

    out = fmt()
    _attach_metadata(path, out)  # sets each result's "metadata": repeatable
    reply = {"results": out, "num_queries": len(out)}
    response = json.dumps(reply)
    ms = {
        "client payload (base64, json.dumps)": median_ms(payload, reps),
        "server json.loads": median_ms(lambda: json.loads(body), reps),
        "server pydantic model": median_ms(lambda: dto.SearchRequest(**parsed), reps),
        "server decode_embeddings": median_ms(lambda: [q.to_array() for q in req.queries], reps),
        "server search_batch": median_ms(lambda: search_batch(index, arrays, params), reps),
        "server format results": median_ms(fmt, reps),
        "server _attach_metadata": median_ms(lambda: _attach_metadata(path, out), reps),
        "server response json.dumps": median_ms(lambda: json.dumps(reply), reps),
        "client json.loads": median_ms(lambda: json.loads(response), reps),
    }
    http_ms = median_ms(lambda: client.search("scifact", queries, top_k=10), reps)
    return ms, http_ms, len(body), len(response)


def service_phase(device, mk, src_path, topics, queries, widths=GTE_WIDTHS):
    """This slice's main path: the REST service on the card. The SciFact
    index (a copy of `src_path`, with the server's config.json, metadata and
    FTS on every doc) and the encoder at GTE-ModernColBERT-v1's widths behind
    `build_app`, in this process; traffic through the port's SDK: (a) the
    queries as 64-query base64 requests from 8 clients, (b) one query a
    request from 16 clients, (c) filtered and hybrid searches, (d) text
    queries, /encode and /rerank_with_encoding, (e) three ingest batches
    appended in place into the served grid, then /update_with_encoding, (f)
    serve_mode grid_only (the int8 kernel) on a copy, (h) one request split
    by stage; then (g) the server as a subprocess, stopped by SIGTERM. Each
    answer is held against the same call in process, and each kernel
    against its plain version at a request's shapes. Returns the two
    kernels' launches in the phase and their largest differences from the
    plain versions."""
    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.api import state as port_state
    from nextplaid_tpu_torch.api.inprocess import InProcessServer
    from nextplaid_tpu_torch.api.models import IndexConfigStored
    from nextplaid_tpu_torch.client import NextPlaidClient
    from nextplaid_tpu_torch.client.client import _doc_payload
    from nextplaid_tpu_torch.encoder import BackboneConfig, Colbert, init_random_params
    from nextplaid_tpu_torch.filtering import text_search
    from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters, load_grid_only, search_batch
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.ops.maxsim import maxsim_score
    from nextplaid_tpu_torch.storage.npy import atomic_write_json, load_json

    t_phase = time.perf_counter()
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    index_dir = os.path.join(SERVICE_DIR, "indices")
    path, grid_path = os.path.join(index_dir, "scifact"), os.path.join(index_dir, "scifact_grid")
    bf16, int8 = mk.maxsim_grid_scores, mk.maxsim_grid_scores_int8i
    try:
        shutil.copytree(src_path, path)
        n0 = load_json(os.path.join(path, "metadata.json"))["num_documents"]
        filtering.create(path, doc_metadata(range(n0)), list(range(n0)))
        text_search.index(path, doc_metadata(range(n0)), list(range(n0)))
        atomic_write_json(os.path.join(path, "config.json"), IndexConfigStored().model_dump())
        shutil.copytree(path, grid_path)
        atomic_write_json(os.path.join(grid_path, "config.json"),
                          IndexConfigStored(serve_mode="grid_only").model_dump())
        bcfg = BackboneConfig(**widths)
        tok = WhitespaceTokenizer(bcfg.vocab_size)
        enc = Colbert(config=colbert_config(tok, bcfg.projection_dim), backbone_config=bcfg,
                      tokenizer=tok, params=init_random_params(bcfg, seed=0),
                      batch_size=ENC_BATCH, device=device)
        texts = make_texts(SVC_ENCODE_REQUESTS * SVC_REQUEST_QUERIES, SVC_ENCODE_WORDS,
                           tok.n_words, seed=5)
        text_queries, _ = excerpt_queries(texts, SVC_TEXT_QUERIES, SVC_QUERY_WORDS, seed=6)

        # In-process references, loaded as AppState loads (before any ingest).
        params = SearchParameters(top_k=10)
        n_eval, nq = 64, len(queries)
        oracle = search_batch(DeviceIndex.load(path, device=device), queries[:n_eval],
                              SearchParameters(top_k=10, mode="exact", stage1_precision="highest"))
        ref = DeviceIndex.load(path, capacity_factor=port_state.SERVE_CAPACITY_FACTOR,
                               grid_aware_capacity=True, device=device).with_token_grid()
        if ref.token_grid is None or ref.grid_is_int8:
            raise AssertionError("the served load did not pin a bf16 grid")
        want = search_batch(ref, queries, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SVC_PASSES):
            want = search_batch(ref, queries, params)
        inproc_qps = SVC_PASSES * nq / (time.perf_counter() - t0)
        qc = queries[:SVC_REQUEST_QUERIES]
        subset = filtering.where_condition(path, *SVC_FILTER)
        want_filtered = search_batch(ref, qc, params, subset=subset)
        kw_text = [f"{TITLE_WORDS[i % len(TITLE_WORDS)]} study" for i in range(len(qc))]
        sem = search_batch(ref, qc, SearchParameters(top_k=30))
        kw = [text_search.search(path, text_search.sanitize_fts5_query(t), 30) for t in kw_text]
        want_text = [search_batch(ref, enc.encode_queries([t]), params) for t in text_queries]
        ref_grid = load_grid_only(grid_path, dtype="int8", device=device)
        want_grid = search_batch(ref_grid, queries, params)
        enc.encode_documents(texts[:SVC_REQUEST_QUERIES])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_documents(texts)
        inproc_docs_s = len(texts) / (time.perf_counter() - t0)
        setup_s = time.perf_counter() - t_phase

        t0 = time.perf_counter()
        server = InProcessServer(index_dir, enc, device)
        start_s = time.perf_counter() - t0
        client = NextPlaidClient(server.url, timeout=600)
        launches = {}
        state_log = _Messages()
        logging.getLogger("nextplaid_tpu_torch.api.state").addHandler(state_log)
        try:
            health = client.health()
            if health["model"]["embedding_dim"] != bcfg.projection_dim or [
                i["name"] for i in health["indices"]
            ] != ["scifact", "scifact_grid"]:
                raise AssertionError(f"/health: {health}")
            # The first request loads and pins the index: outside the count.
            client.search("scifact", queries[:SVC_REQUEST_QUERIES], top_k=10)
            client.search("scifact_grid", queries[:SVC_REQUEST_QUERIES], top_k=10)
            bf16.launches = int8.launches = 0

            def step(label, kernel):
                """Note the kernel's count before a step (`grew` after it)."""
                launches[label] = kernel.launches

            def grew(label, kernel):
                """The step's launches; fail if none."""
                n = kernel.launches - launches[label]
                if n <= 0:
                    raise AssertionError(f"service ({label}) launched its kernel {n} times")
                launches[label] = n

            def batch_requests(name):
                chunks = [queries[s : s + SVC_REQUEST_QUERIES]
                          for s in range(0, nq, SVC_REQUEST_QUERIES)]
                jobs = [lambda c, q=q: c.search(name, q, top_k=10)
                        for _ in range(SVC_PASSES * SVC_CLIENTS) for q in chunks]
                return run_clients(SVC_CLIENTS, jobs, server.url), len(chunks)

            # (a) 64-query base64 requests, 8 clients.
            step("a", bf16)
            with timed_kernel_launches(mk) as windows:
                (out, wall_a, _), per_pass = batch_requests("scifact")
            grew("a", bf16)
            got = [r for body in out for r in http_results(body)]
            for p in range(0, len(got), nq):
                assert_same_topk(got[p : p + nq], want, SVC_RTOL, "service (a) vs in-process")
            recall = recall_at_10(got[:n_eval], oracle)
            if recall < MIN_RECALL:
                raise AssertionError(f"service (a) recall@10 {recall} < {MIN_RECALL}")
            if any(m is None or m["_subset_"] != i for r in got[:nq]
                   for i, m in zip(r.passage_ids, r.metadata)):
                raise AssertionError("service (a): metadata missing or misattached")
            qps_a = len(got) / wall_a
            share = kernel_busy_ms(windows) / (1e3 * wall_a)
            print(f"service (a) [{SVC_CLIENTS} clients, each {SVC_PASSES} passes of {per_pass} "
                  f"requests of {SVC_REQUEST_QUERIES} queries, base64 f32]: {len(got)} queries "
                  f"in {wall_a:.3f} s, {qps_a:.1f} QPS; in-process search_batch of the {nq} "
                  f"queries {inproc_qps:.1f} QPS; bf16 kernel busy {100 * share:.1f}% of the "
                  f"wall ({len(windows)} launches, CUDA events); recall@10 vs f32 oracle "
                  f"{recall:.4f}; top-10 = in-process", flush=True)

            # (b) one query a request, 16 clients (coalesced on the server).
            step("b", bf16)
            jobs = [lambda c, q=q: c.search("scifact", [q], top_k=10) for q in queries]
            out, wall_b, lat = run_clients(SVC_SINGLE_CLIENTS, jobs, server.url)
            grew("b", bf16)
            assert_same_topk([http_results(b)[0] for b in out], want, SVC_RTOL,
                             "service (b) vs in-process")
            lat_ms = sorted(1e3 * x for x in lat)
            print(f"service (b) [{nq} single-query requests, {SVC_SINGLE_CLIENTS} clients]: "
                  f"{nq / wall_b:.1f} QPS, latency p50 {lat_ms[len(lat_ms) // 2]:.2f} ms, p95 "
                  f"{lat_ms[int(0.95 * len(lat_ms))]:.2f} ms; top-10 = in-process", flush=True)

            # (c) filtered, then hybrid under both fusions.
            step("c", bf16)
            body = client.search("scifact", qc, top_k=10, filter_condition=SVC_FILTER[0],
                                 filter_parameters=SVC_FILTER[1])
            got = http_results(body)
            if not set(i for r in got for i in r.passage_ids) <= set(subset):
                raise AssertionError("service (c): a filtered result lies outside the subset")
            assert_same_topk(got, want_filtered, SVC_RTOL, "service (c) filtered vs in-process")
            for fusion in ("relative_score", "rrf"):
                body = client.search("scifact", qc, top_k=10, text_query=kw_text,
                                     alpha=SVC_ALPHA, fusion=fusion)
                fused = []
                for s, (kw_ids, kw_scores) in zip(sem, kw):
                    if fusion == "rrf":
                        ids, scores = text_search.fuse_rrf(s.passage_ids, kw_ids, SVC_ALPHA, 10)
                    else:
                        ids, scores = text_search.fuse_relative_score(
                            s.passage_ids, s.scores, kw_ids, kw_scores, SVC_ALPHA, 10)
                    fused.append((ids, scores))
                for r, (ids, scores) in zip(http_results(body), fused):
                    if r.passage_ids != ids or not np.allclose(r.scores, scores, rtol=SVC_RTOL,
                                                               atol=SVC_RTOL):
                        raise AssertionError(f"service (c) {fusion}: fused list differs")
            grew("c", bf16)
            print(f"service (c): filter {SVC_FILTER[0]!r} keeps {len(subset)} of {n0} docs "
                  f"({100 * len(subset) / n0:.1f}%), {len(qc)} queries answered inside it = "
                  f"in-process; hybrid (alpha {SVC_ALPHA}) relative_score and rrf = "
                  f"text_search.fuse_* in process", flush=True)

            # (d) text queries one a request, /encode, /rerank_with_encoding.
            step("d", bf16)
            lat = []
            for t, mine in zip(text_queries, want_text):
                t0 = time.perf_counter()
                body = client.search("scifact", [t], top_k=10)
                lat.append(time.perf_counter() - t0)
                assert_same_topk(http_results(body), mine, SVC_RTOL, "service (d) vs in-process")
            grew("d", bf16)
            client.encode(texts[:SVC_REQUEST_QUERIES])  # warm-up: this shape's first forward
            t0 = time.perf_counter()
            encoded = [a for k in range(SVC_ENCODE_REQUESTS) for a in client.encode(
                texts[k * SVC_REQUEST_QUERIES : (k + 1) * SVC_REQUEST_QUERIES])]
            encode_s = time.perf_counter() - t0
            mine = enc.encode_documents(texts[:SVC_REQUEST_QUERIES])
            cos = min(per_token_cos(torch.from_numpy(g)[None], torch.from_numpy(w)[None],
                                    torch.ones(1, len(w), dtype=torch.bool))
                      for g, w in zip(encoded, mine) if g.shape == w.shape)
            if ([g.shape for g in encoded[: len(mine)]] != [w.shape for w in mine]
                    or cos < ENC_MIN_COS_BF16):
                raise AssertionError(f"service (d): /encode differs from in-process ({cos})")
            ranked = client.rerank(text_queries[0], texts[:SVC_RERANK_DOCS])
            q_emb = torch.from_numpy(enc.encode_queries([text_queries[0]])[0]).to(device)
            scores = [float(maxsim_score(q_emb, torch.from_numpy(d).to(device)))
                      for d in enc.encode_documents(texts[:SVC_RERANK_DOCS])]
            if not all(abs(r["score"] - scores[r["index"]]) <= SVC_RTOL * abs(scores[r["index"]])
                       for r in ranked) or len(ranked) != SVC_RERANK_DOCS:
                raise AssertionError("service (d): /rerank_with_encoding differs from in-process")
            lat_ms = sorted(1e3 * x for x in lat)
            n_enc = len(encoded)
            print(f"service (d): /search_with_encoding of {len(text_queries)} text queries one a "
                  f"request, p50 {lat_ms[len(lat_ms) // 2]:.2f} ms (p95 "
                  f"{lat_ms[int(0.95 * len(lat_ms))]:.2f} ms), top-10 = in-process encode + "
                  f"search; /encode {n_enc} docs of {SVC_ENCODE_WORDS} words in "
                  f"{SVC_ENCODE_REQUESTS} requests after one warm-up request, "
                  f"{n_enc / encode_s:.1f} docs/s (in process {inproc_docs_s:.1f}; least cosine "
                  f"vs in-process {cos:.6f}); /rerank_with_encoding of {SVC_RERANK_DOCS} docs = "
                  f"in-process", flush=True)

            # (e) ingest: appended in place into the served bf16 grid.
            step("e", bf16)
            served = server.state.served("scifact")
            ptr = served.token_grid.data_ptr()
            ingest_ms = []
            for k in range(SVC_INGEST_BATCHES):
                docs = new_docs(topics, MUT_BATCH, seed=500 + k)
                first = n0 + k * MUT_BATCH
                ids = list(range(first, first + MUT_BATCH))
                t0 = time.perf_counter()
                resp = client._request("POST", "/indices/scifact/documents", json={
                    "documents": [_doc_payload(d) for d in docs], "metadata": doc_metadata(ids)})
                ingest_ms.append(1e3 * (time.perf_counter() - t0))
                served = server.state.served("scifact")
                if (resp["start_id"], resp["total_documents"]) != (first, first + MUT_BATCH):
                    raise AssertionError(f"service (e): ingest answered {resp}")
                if served.token_grid.data_ptr() != ptr or served.num_documents != first + MUT_BATCH:
                    raise AssertionError("service (e): the served grid was reloaded, not appended")
                body = client.search("scifact", [d[:32] for d in docs], top_k=10)
                if [r.passage_ids[0] for r in http_results(body)] != ids:
                    raise AssertionError("service (e): a new doc is not its own query's top hit")
            grew("e", bf16)
            fallbacks = [m for m in state_log.messages if "falling back" in m]
            if fallbacks:
                raise AssertionError(f"service (e): {fallbacks}")
            t0 = time.perf_counter()
            resp = client.add("scifact", texts[:MUT_BATCH], doc_metadata(range(MUT_BATCH)))
            upd_s = time.perf_counter() - t0
            total = n0 + (SVC_INGEST_BATCHES + 1) * MUT_BATCH
            if resp["total_documents"] != total or client.get_index("scifact")[
                "metadata_count"
            ] != total:
                raise AssertionError(f"service (e): /update_with_encoding answered {resp}")
            print(f"service (e): {SVC_INGEST_BATCHES} ingest batches of {MUT_BATCH} docs through "
                  f"/documents, POST to searchable "
                  f"{', '.join(f'{x:.1f}' for x in ingest_ms)} ms, each appended in place (grid "
                  f"data_ptr unchanged, doc count +{MUT_BATCH}), every new doc its own query's "
                  f"top hit; /update_with_encoding of {MUT_BATCH} texts {upd_s:.2f} s "
                  f"(centroid expansion and reload), {total} docs", flush=True)

            # (f) serve_mode grid_only: the int8 kernel.
            step("f", int8)
            (out, wall_f, _), _ = batch_requests("scifact_grid")
            grew("f", int8)
            got = [r for body in out for r in http_results(body)]
            for p in range(0, len(got), nq):
                assert_same_topk(got[p : p + nq], want_grid, SVC_RTOL,
                                 "service (f) grid_only vs in-process")
            print(f"service (f) [serve_mode grid_only, int8 grid]: {len(got)} queries in "
                  f"{wall_f:.3f} s, {len(got) / wall_f:.1f} QPS; top-10 = in-process "
                  f"load_grid_only", flush=True)
            # (h) one 64-query request, and one single-query request, split
            # by stage (each stage alone, this thread; then over HTTP from
            # one sequential client).
            served = server.state.served("scifact")
            for label, qs in (("64-query", queries[:SVC_REQUEST_QUERIES]), ("1-query", queries[:1])):
                ms, http_ms, up, down = request_stages(client, served, path, qs)
                print(f"service (h) [{label} request, median of {SVC_STAGE_REPS}]: "
                      + "; ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
                      + f"; sum {sum(ms.values()):.3f} ms; over HTTP, one client "
                      f"{http_ms:.3f} ms, transport and hops {http_ms - sum(ms.values()):.3f} ms; "
                      f"{up / 2**20:.3f} MiB up, {down / 2**20:.3f} MiB down", flush=True)
            # What the subprocess server of (g) must answer on the same files.
            last = http_results(client.search("scifact", queries[:1], top_k=10))
            # Each kernel against its plain version at the service's shapes:
            # a 64-query request over the served grids (after the counts).
            q_arr, _ = _pad_queries(queries[:SVC_REQUEST_QUERIES], 128)
            tq = q_arr.shape[1]
            qflat = torch.from_numpy(q_arr.reshape(-1, 128)).to(device)
            served = server.state.served("scifact")
            lens = torch.zeros(served.token_grid.shape[0], dtype=torch.int32, device=device)
            lens[: served.num_docs_padded] = served.doclens
            err16 = check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference,
                                 (qflat.to(torch.bfloat16), served.token_grid, lens, tq),
                                 f"bf16 service request {SVC_REQUEST_QUERIES}q x "
                                 f"{tuple(served.token_grid.shape)}")
            served = server.state.served("scifact_grid")
            qi8, qs = quantize_queries_int8(qflat)
            grids = served.grid_buckets or (served.token_grid,)
            scales = served.scale_buckets or (served.token_scales,)
            err8 = max(check_kernel(mk.maxsim_grid_scores_int8i,
                                    mk.maxsim_grid_scores_int8i_reference,
                                    (qi8, qs, g, sc, tq),
                                    f"int8 grid_only service request {SVC_REQUEST_QUERIES}q x "
                                    f"{tuple(g.shape)}")
                       for g, sc in zip(grids, scales))
        finally:
            logging.getLogger("nextplaid_tpu_torch.api.state").removeHandler(state_log)
            server.stop()
        bf16_n = sum(launches[k] for k in "abcde")
        del server, ref, ref_grid, enc
        gc.collect()
        torch.cuda.empty_cache()

        # (g) the server as a subprocess: answers, then exits 0 on SIGTERM.
        import signal

        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nextplaid_tpu_torch.api.server", "--host", "127.0.0.1",
             "--port", str(port), "--index-dir", index_dir, "--device", device.type],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        try:
            sub = NextPlaidClient(f"http://127.0.0.1:{port}", timeout=300)
            t0 = time.perf_counter()
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"the server process exited with {proc.returncode}: "
                                         f"{proc.stdout.read().decode(errors='replace')[-2000:]}")
                try:
                    if sub.health()["status"] == "ok":
                        break
                except Exception:  # noqa: BLE001 - not listening yet
                    if time.perf_counter() - t0 > 300:
                        raise
                    time.sleep(0.25)
            up_s = time.perf_counter() - t0
            assert_same_topk(http_results(sub.search("scifact", queries[:1], top_k=10)), last,
                             SVC_RTOL, "service (g) vs the in-process server")
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=SVC_SIGTERM_S)
            stop_s = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"service (g): the server exited {rc} on SIGTERM")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
        print(f"service (g): python -m nextplaid_tpu_torch.api.server --device {device.type} "
              f"healthy after {up_s:.1f} s, answered a search, exited 0 {stop_s:.2f} s after "
              f"SIGTERM", flush=True)
        print(f"service: launches bf16 {bf16_n} ("
              f"{', '.join(f'{k} {launches[k]}' for k in 'abcde')}), int8 {launches['f']}; "
              f"setup {setup_s:.1f} s, server start {start_s:.1f} s; the phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        return {"bf16": {"service_launches": bf16_n, "service_max_abs_err": err16},
                "int8": {"service_launches": launches["f"], "service_max_abs_err": err8}}
    finally:
        shutil.rmtree(SERVICE_DIR, ignore_errors=True)


# RQ phase: the residual-quantized codebook at its own operating point,
# K = RQ_MIN_K = 65,536 (C 256 x F 256), on the first 110,000 docs of the
# megascale corpus's generator (~17.6M tokens): the K heuristic gives 65,536
# there. Staged search at STAGED_POINTS and "quality" over the RQ index and
# over the same index with its rq_* fields set to None (the flat control).
# Recall is held to the flat control's, not to the megascale records: a
# query's 32 tokens hit a doc's topics ~0.31 times on average (Poisson), so
# among 110,000 docs ~2 share five of its topics and ~32 share four, and the
# oracle's top-10 is mostly decided by noise among the latter; at 473,000
# docs ~9 share five. So the flat pipeline's own recall@10 is far below
# the records here, and what the phase measures is the gap between the RQ
# stages 1-2 and the flat ones on the same index.
RQ_DIR = os.path.join(ROOT, "build", "chip_smoke_rq")
RQ_DOCS = 110_000


@contextlib.contextmanager
def timed_calls(owner, name, totals, key, sync=False):
    """Replace `owner.name` by a wrapper that adds each call's seconds (after
    a device sync when `sync`) to `totals[key]`, and put it back after."""
    fn = getattr(owner, name)
    totals.setdefault(key, 0.0)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        totals[key] += time.perf_counter() - t0
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def staged_point_runs(index, batches, params, kernel, q_dev, m_dev):
    """One operating point on one index: STAGED_PASSES passes of
    MEGA_IN_FLIGHT batches in flight, then one batch stage by stage (median
    of 3 runs, CUDA events). Returns (first batch's results, QPS list,
    (bf16 kernel, union grid kernel, stage-3b kernel) launches, stage ms
    dict, shapes)."""
    from nextplaid_tpu_torch.index import search_batch, search_batch_async
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.ops import approx_codes as A
    from nextplaid_tpu_torch.ops import union_grid as U

    search_batch(index, batches[0], params)  # warm-up
    torch.cuda.synchronize()
    kernel.launches = U.union_grid.launches = A.approx_codes.launches = 0
    pass_s, out, pending = [], None, None
    for _ in range(STAGED_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = [search_batch_async(index, batches[i % len(batches)], params)
                   for i in range(MEGA_IN_FLIGHT)]
        out = [p.result() for p in pending]
        pass_s.append(time.perf_counter() - t0)
    launches = (kernel.launches, U.union_grid.launches, A.approx_codes.launches)
    shapes = pending[0].shapes
    if shapes is None or not shapes.rerank_kernel:
        raise AssertionError("staged search did not take the stage-4 kernel route")
    runs = []
    for _ in range(3):
        marks = []
        S.search_pipeline(index, q_dev, m_dev, None, shapes, marks=marks)
        torch.cuda.synchronize()
        runs.append({b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])})
    stage = {name: statistics.median(r[name] for r in runs) for name in runs[0]}
    qps = [MEGA_IN_FLIGHT * MEGA_BATCH / s for s in pass_s]
    return out[0], qps, launches, stage, shapes


def rq_phase(device, mk, n_docs=RQ_DOCS):
    """The RQ codebook on the card: `create_index_streamed(centroid_structure
    ="rq")` at K = RQ_MIN_K (train, assign and the rest timed apart), load,
    and staged search at STAGED_POINTS and "quality" with stages 1-2 over the
    factored codebook and stage 4 through the bf16 kernel, against the flat
    control (the same index, stages 1-2 over its materialized table) and the
    f32 exhaustive oracle. Without the [Q, Tq, K] score table the RQ path
    ranks approx_score="codes" by the cell weights (as the JAX package
    does), so at a "codes" point the gate's control runs the flat index at
    "cells" with the same keep; the flat control at the point's own
    parameters is printed beside it. The union grid kernel builds each
    batch's stage-4 grid on both; at a "codes" point the flat control's
    stage 3b is one launch of csrc/approx_codes.cu a batch, the RQ index's
    none. The stage-3b kernel is then checked on the flat control at the
    LoTTE staged cell's operating point (K 65,536, pool 4,096). Returns the
    bf16 kernel's RQ numbers, the union grid kernel's and the stage-3b
    kernel's."""
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index_streamed, search_batch,
    )
    from nextplaid_tpu_torch.index import build as build_mod
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.index.config import resolve_target_recall
    from nextplaid_tpu_torch.ops import kmeans as kmeans_ops
    from nextplaid_tpu_torch.ops import rq as rq_ops

    t_phase = time.perf_counter()
    shutil.rmtree(RQ_DIR, ignore_errors=True)
    path = os.path.join(RQ_DIR, "rq")
    try:
        chunks, sample, lens, topics = mega_corpus(device, n_docs)
        total = int(lens.sum())
        k = kmeans_ops.num_partitions_heuristic(float(total))
        if k != rq_ops.RQ_MIN_K:
            raise AssertionError(f"K heuristic gives {k} at {total} tokens, not RQ_MIN_K")
        split = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_calls(rq_ops, "train_rq", split, "train", sync=True), \
                timed_calls(build_mod, "assign_with_artifacts", split, "assign", sync=True):
            meta = create_index_streamed(
                chunks, path, IndexConfig(nbits=2, seed=42, centroid_structure="rq"),
                sample_tokens=sample, est_total_tokens=total,
            )
        build_s = time.perf_counter() - t0
        del sample
        gc.collect()
        torch.cuda.empty_cache()
        c, f = (np.load(os.path.join(path, n), mmap_mode="r").shape[0]
                for n in ("rq_coarse.npy", "rq_fine.npy"))
        if (meta.num_partitions, (c, f)) != (rq_ops.RQ_MIN_K, rq_ops.rq_split(rq_ops.RQ_MIN_K)):
            raise AssertionError(f"RQ build has K {meta.num_partitions} = {c} x {f}")
        print(f"rq build: {meta.num_documents} docs, {meta.num_embeddings} tokens, K "
              f"{meta.num_partitions} = C {c} x F {f}, nbits 2; create_index_streamed "
              f"{build_s:.2f} s: train_rq {split['train']:.2f} s, assign_codes_rq "
              f"{split['assign']:.2f} s, the rest (residual quantization, chunk files, IVF) "
              f"{build_s - split['train'] - split['assign']:.2f} s", flush=True)

        t0 = time.perf_counter()
        full = DeviceIndex.load(path)
        load_s = time.perf_counter() - t0
        if full.rq_coarse is None or tuple(full.rq_inv_norms.shape) != (c, f):
            raise AssertionError("DeviceIndex.load did not carry the RQ codebook")
        degenerate = int((full.rq_inv_norms == 0).sum())
        flat = dataclasses.replace(full, rq_coarse=None, rq_fine=None, rq_inv_norms=None)
        queries = mega_queries(topics)
        batches = [queries[s : s + MEGA_BATCH] for s in range(0, len(queries), MEGA_BATCH)]
        t0 = time.perf_counter()
        oracle = search_batch(full, batches[0], SearchParameters(
            top_k=10, mode="exact", stage1_precision="highest"))
        oracle_s = time.perf_counter() - t0
        print(f"rq load: {load_s:.2f} s, {degenerate} degenerate pairs of {c * f}; f32 "
              f"exhaustive oracle on {MEGA_BATCH} queries {oracle_s:.2f} s", flush=True)

        kernel = mk.maxsim_grid_scores
        q_arr, q_mask = S._pad_queries(batches[0], full.dim)
        q_dev = torch.from_numpy(q_arr).to(device)
        m_dev = torch.from_numpy(q_mask).to(device)
        points = [(label, SearchParameters(**STAGED_COMMON, **kw))
                  for label, kw, _ in STAGED_POINTS]
        points.append(('preset "quality"', SearchParameters.preset("quality", **STAGED_COMMON)))
        rq_launches = flat_launches = union_launches = approx_launches = 0
        for label, params in points:
            resolved = resolve_target_recall(params)
            got, qps, launches, stage, shapes = staged_point_runs(
                full, batches, params, kernel, q_dev, m_dev)
            ctl, ctl_qps, ctl_launches, ctl_stage, _ = staged_point_runs(
                flat, batches, params, kernel, q_dev, m_dev)
            gate = ctl_recall = recall_at_10(ctl, oracle)
            gate_note = ""
            if resolved.approx_score == "codes":
                cells = dataclasses.replace(resolved, approx_score="cells",
                                            prune_keep=shapes.prune_keep)
                gate = recall_at_10(search_batch(flat, batches[0], cells), oracle)
                gate_note = f" (flat at cells keep {shapes.prune_keep}: {gate:.4f})"
            want = STAGED_PASSES * MEGA_IN_FLIGHT
            want_a = want if resolved.approx_score == "codes" else 0
            if launches != (want, want, 0) or ctl_launches != (want, want, want_a):
                raise AssertionError(f"rq [{label}] launched the bf16, union grid and stage-3b "
                                     f"kernels {launches} (RQ) / {ctl_launches} (flat) times in "
                                     f"{want} batches")
            (launches, u_rq, _), (ctl_launches, u_flat, a_flat) = launches, ctl_launches
            approx_launches += a_flat
            rq_launches += launches
            flat_launches += ctl_launches
            union_launches += u_rq + u_flat
            check_results(got, MEGA_BATCH)
            recall = recall_at_10(got, oracle)
            rest = sum(v for n, v in stage.items() if n != "stage12")
            ctl_rest = sum(v for n, v in ctl_stage.items() if n != "stage12")
            print(f"rq staged [{label}]: {resolved.approx_score} nprobe {shapes.nprobe} keep "
                  f"{shapes.prune_keep}, cmax {shapes.max_candidates}; stages 1-2 "
                  f"{stage['stage12']:.3f} ms RQ vs {ctl_stage['stage12']:.3f} ms flat; stages "
                  f"3-5 {rest:.3f} ms RQ vs {ctl_rest:.3f} ms flat (stage-4 kernel "
                  f"{stage['stage4_kernel']:.3f} ms); p50 {statistics.median(qps):.2f} QPS RQ vs "
                  f"{statistics.median(ctl_qps):.2f} flat; recall@10 {recall:.4f} RQ vs "
                  f"{ctl_recall:.4f} flat{gate_note}; kernel launches {launches} RQ + "
                  f"{ctl_launches} flat, union grid {u_rq} RQ + {u_flat} flat, stage 3b "
                  f"{a_flat} flat", flush=True)
            floor = gate - RECALL_SLACK
            if recall < floor:
                raise AssertionError(f"rq [{label}] recall@10 {recall} < {floor}")

        # Both kernels alone at the RQ path's stage-4 shape (the largest union
        # grid), beside their plain versions and their bounds.
        label, kw, _ = STAGED_POINTS[1]
        params = SearchParameters(**STAGED_COMMON, **kw)
        shapes = S.PipelineShapes.derive(full, params, MEGA_BATCH, q_arr.shape[1])
        cells, weights = S._dedup_cells(*S._select_cells_rq(q_dev, m_dev, full, shapes),
                                        full.num_centroids, threshold=shapes.threshold)
        union_ids, _, _ = S._prune_candidates(full, cells, weights, shapes, qmask=m_dev)
        union_numbers = union_grid_check(full, union_ids, shapes, f"rq stage 4 [{label}]")
        grid, doclens = S._build_union_grid(full, union_ids, shapes)
        tq = q_arr.shape[1]
        args = (q_dev.reshape(-1, full.dim).to(torch.bfloat16), grid, doclens, tq)
        max_err = check_kernel(kernel, mk.maxsim_grid_scores_reference, args,
                               f"rq stage-4 union grid {tuple(grid.shape)}, {MEGA_BATCH}q")
        kernel_ms = time_ms(lambda: kernel(*args), reps=5)
        plain_ms = time_ms(lambda: mk.maxsim_grid_scores_reference(*args), reps=1)
        bound_ms, bound_by, _ = maxsim_bound(*args)
        print(f"rq stage-4 kernel [{label}]: union {int((union_ids < full.num_documents).sum())} "
              f"docs, {int(doclens.sum())} valid tokens; kernel {kernel_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({bound_by}; {100 * bound_ms / kernel_ms:.1f}% of it), plain "
              f"version {plain_ms:.3f} ms; launches {rq_launches} on the RQ index, "
              f"{flat_launches} on the flat control; the phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        del grid, doclens
        # Stage 3b's kernel on the flat control at the LoTTE staged cell's
        # operating point (benchmark/traffic/batch64_staged_w2.json).
        cell = SearchParameters(top_k=10, mode="staged", n_ivf_probe=8, n_full_scores=4096,
                                centroid_score_threshold=0.4, approx_score="codes")
        approx_numbers = approx_codes_check(
            flat, q_dev, m_dev, S.PipelineShapes.derive(flat, cell, MEGA_BATCH, q_arr.shape[1]),
            "flat control, the LoTTE staged cell's point")
        del full, flat
        gc.collect()
        torch.cuda.empty_cache()
        return ({"rq_launches": rq_launches, "rq_max_abs_err": max_err, "rq_ms": kernel_ms,
                 "rq_plain_ms": plain_ms, "rq_bound_ms": bound_ms, "rq_bound_by": bound_by},
                {"rq_launches": union_launches, **{f"rq_{k}": v for k, v in union_numbers.items()}},
                {"launches": approx_launches, **approx_numbers})
    finally:
        shutil.rmtree(RQ_DIR, ignore_errors=True)


# Code-search phase: the `cgrep` path over this checkout's own files, with the
# encoder at GTE-ModernColBERT-v1's widths (random weights from seed 0) and a
# character-fallback WordPiece tokenizer made in the process, as
# tests/test_codesearch.py's fixture makes it.
CS_DIR = os.path.join(ROOT, "build", "chip_smoke_codesearch")
CS_QUERIES = 50
# The filtered searches' keyword leg (FTS over a subset) takes 0.2-0.8 s a
# query on the host, and a CPU search of the index ~1.7 s: fewer queries.
CS_FILTER_QUERIES = 12
CS_CPU_QUERIES = 6
CS_OPTIONS = (
    ("no filter", {}),
    ("path", dict(path_prefix="nextplaid_tpu_torch")),
    ("glob", dict(include_globs=["*.py"])),
    ("regex", dict(regex=r"def \w+\(")),
)
CS_EDITED = os.path.join("nextplaid_tpu_torch", "index", "search.py")
CS_RTOL = 1e-4


def char_wordpiece():
    """A character-fallback WordPiece over lowercase letters, digits and _
    with the ColBERT specials (any code token is encodable)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.normalizers import Lowercase
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.processors import TemplateProcessing

    vocab = {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[MASK]": 3, "[UNK]": 4, "[Q]": 5, "[D]": 6}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789_":
        vocab[ch] = len(vocab)
        vocab[f"##{ch}"] = len(vocab)
    tok = Tokenizer(WordPiece(vocab, unk_token="[UNK]", max_input_chars_per_word=200))
    tok.pre_tokenizer = Whitespace()
    tok.post_processor = TemplateProcessing(single="[CLS] $A [SEP]",
                                            special_tokens=[("[CLS]", 1), ("[SEP]", 2)])
    tok.normalizer = Lowercase()
    return tok, vocab


def write_model_dir(path, params, widths, tok, ccfg):
    """A model directory the port's `Colbert(model_dir)` loads: config.json,
    model.safetensors under ModernBERT's HF names, the projection in
    1_Dense/, tokenizer.json and colbert_config.json."""
    from safetensors.numpy import save_file

    os.makedirs(os.path.join(path, "1_Dense"), exist_ok=True)

    def w(name):
        return np.ascontiguousarray(params[f"backbone.{name}"].numpy())

    def t(name):  # a dense kernel [in, out] as HF's weight [out, in]
        return np.ascontiguousarray(w(name).T)

    sd = {"embeddings.tok_embeddings.weight": w("word_embeddings.embedding"),
          "embeddings.norm.weight": w("emb_norm.scale"),
          "final_norm.weight": w("final_norm.scale")}
    for i in range(widths["num_hidden_layers"]):
        sd[f"layers.{i}.attn.Wqkv.weight"] = t(f"layer_{i}.attn.Wqkv.kernel")
        sd[f"layers.{i}.attn.Wo.weight"] = t(f"layer_{i}.attn.Wo.kernel")
        sd[f"layers.{i}.mlp_norm.weight"] = w(f"layer_{i}.mlp_norm.scale")
        sd[f"layers.{i}.mlp.Wi.weight"] = t(f"layer_{i}.Wi.kernel")
        sd[f"layers.{i}.mlp.Wo.weight"] = t(f"layer_{i}.Wo.kernel")
        if i:
            sd[f"layers.{i}.attn_norm.weight"] = w(f"layer_{i}.attn_norm.scale")
    save_file(sd, os.path.join(path, "model.safetensors"))
    save_file({"linear.weight": np.ascontiguousarray(params["projection.kernel"].numpy().T)},
              os.path.join(path, "1_Dense", "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(widths, fh)
    tok.save(os.path.join(path, "tokenizer.json"))
    ccfg.save(os.path.join(path, "colbert_config.json"))


def copy_checkout(dst):
    """This checkout's files (`git ls-files`, or, where there is no .git, a
    walk that skips what the indexer skips), build/ left out. Returns the
    relative paths copied."""
    try:
        rels = subprocess.run(["git", "ls-files"], cwd=ROOT, capture_output=True, text=True,
                              check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        from nextplaid_tpu_torch.codesearch.indexer import SKIP_DIRS

        rels = []
        for root, dirs, files in os.walk(ROOT):
            dirs[:] = [d for d in dirs if d not in SKIP_DIRS and not d.startswith(".")]
            rels.extend(os.path.relpath(os.path.join(root, n), ROOT) for n in files)
    rels = sorted(r for r in rels if not r.startswith("build/")
                  and os.path.isfile(os.path.join(ROOT, r)))
    for rel in rels:
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        shutil.copy2(os.path.join(ROOT, rel), os.path.join(dst, rel))
    return rels


def same_hits(got, want, tol, label):
    """Hit lists equal in (file, name, line) and score, except that hits
    tied with the last one's score (within `tol`) may trade places."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} hits vs {len(want)}")
    if not np.allclose([h.score for h in got], [h.score for h in want], rtol=tol, atol=tol):
        raise AssertionError(f"{label}: scores differ beyond {tol}")
    key = [(h.file, h.name, h.line) for h in got]
    ref = [(h.file, h.name, h.line) for h in want]
    if key != ref:
        last = want[-1].score if want else 0.0
        for k, h in zip(key, got):
            if k not in ref and abs(h.score - last) > tol * (1 + abs(last)):
                raise AssertionError(f"{label}: hit {k} (score {h.score}) in one list only")


def codesearch_phase(device, mk, widths=GTE_WIDTHS, n_queries=CS_QUERIES):
    """Code search on the card: `ProjectIndexer(device="cuda").update()` over
    a copy of this checkout (parse, encode and ingest timed apart), an
    incremental update after one file is edited, `Searcher.search` for
    queries taken from the tree's own function names and docstrings, with
    and without path, glob and regex filters (split by leg), the card's hits
    against a CPU `search_batch` of the same index and query embeddings, and
    the `cgrep` CLI as a subprocess over a model directory of the same
    weights. No MaxSim kernel is on this path: the index is unpinned and far
    below `exact_max_embeddings`, so `search_batch` takes the exhaustive
    scan, as in the JAX package; the phase checks that neither kernel ran."""
    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.codesearch import ProjectIndexer, Searcher, SearchOptions
    from nextplaid_tpu_torch.codesearch import indexer as indexer_mod
    from nextplaid_tpu_torch.encoder import (
        BackboneConfig, Colbert, ColbertConfig, init_random_params, load_params,
    )

    t_phase = time.perf_counter()
    shutil.rmtree(CS_DIR, ignore_errors=True)
    proj, idx, model_dir = (os.path.join(CS_DIR, n) for n in ("project", "index", "model"))
    try:
        rels = copy_checkout(proj)
        tok, vocab = char_wordpiece()
        cfg = BackboneConfig(**widths)
        ccfg = ColbertConfig(query_prefix="[Q]", document_prefix="[D]", query_length=32,
                             document_length=300, embedding_dim=widths["projection_dim"],
                             mask_token_id=vocab["[MASK]"], pad_token_id=vocab["[PAD]"],
                             uses_token_type_ids=False)
        params = init_random_params(cfg, seed=0)
        write_model_dir(model_dir, params, widths, tok, ccfg)
        loaded = load_params(model_dir, BackboneConfig.from_model_dir(model_dir))
        if loaded.keys() != params.keys() or not all(torch.equal(loaded[n], params[n])
                                                      for n in params):
            raise AssertionError("the model directory does not load back its weights")
        # The CLI's batch sizes: 16 texts a forward, 32 a call of the indexer.
        enc = Colbert(config=ccfg, backbone_config=cfg, tokenizer=tok, params=params,
                      batch_size=16, device=device)
        del loaded
        mk.maxsim_grid_scores.launches = mk.maxsim_grid_scores_int8i.launches = 0

        split, n_tok = {}, [0]
        encode = enc.encode_documents

        def counted(texts, *a, **kw):
            out = encode(texts, *a, **kw)
            n_tok[0] += sum(e.shape[0] for e in out)
            return out

        enc.encode_documents = counted
        indexer = ProjectIndexer(proj, enc, index_dir=idx, device=device)
        t0 = time.perf_counter()
        with timed_calls(indexer_mod, "extract_units", split, "parse"), \
                timed_calls(enc, "encode_documents", split, "encode"), \
                timed_calls(indexer_mod, "update_or_create_with_metadata", split, "ingest"):
            stats = indexer.update()
        index_s = time.perf_counter() - t0
        enc.encode_documents = encode
        rows = filtering.get(idx)
        langs = {}
        for r in rows:
            langs[r["language"]] = langs.get(r["language"], 0) + 1
        if stats["units"] != len(rows) or not rows:
            raise AssertionError(f"indexed {stats['units']} units, the metadata holds {len(rows)}")
        print(f"codesearch index: {len(rels)} files copied, {stats['scanned']} scanned, "
              f"{stats['units']} units ({', '.join(f'{v} {k}' for k, v in sorted(langs.items(), key=lambda kv: -kv[1])[:6])}), "
              f"{n_tok[0]} tokens; update() {index_s:.2f} s: parse {split['parse']:.2f} s, "
              f"encode {split['encode']:.2f} s, ingest {split['ingest']:.2f} s, the rest "
              f"{index_s - split['parse'] - split['encode'] - split['ingest']:.2f} s; "
              f"{stats['units'] / index_s:.1f} units/s", flush=True)

        # Incremental update: one edited file's units replaced, the others'
        # doc ids re-derived from the metadata table.
        edited = os.path.join(proj, CS_EDITED)
        with open(edited, "a") as fh:
            fh.write('\n\ndef chip_smoke_marker(x):\n    """Added by the incremental update."""\n'
                     "    return x\n")
        t0 = time.perf_counter()
        stats2 = indexer.update()
        upd_ms = 1e3 * (time.perf_counter() - t0)
        rows2 = filtering.get(idx)
        by_file = {}
        for r in rows2:
            by_file.setdefault(r["file"], []).append(int(r["_subset_"]))
        if (stats2["changed"], stats2["deleted"]) != (1, 0) or len(rows2) != len(rows) + 1:
            raise AssertionError(f"incremental update: {stats2}, {len(rows2)} rows after "
                                 f"{len(rows)}")
        if any(info["doc_ids"] != by_file.get(rel, []) for rel, info in
               indexer.state["files"].items()):
            raise AssertionError("incremental update: state doc ids differ from the metadata")
        if not any(r["name"] == "chip_smoke_marker" for r in rows2):
            raise AssertionError("incremental update: the new unit is not in the metadata")
        print(f"codesearch update: 1 file edited, {stats2['units']} units re-indexed in "
              f"{upd_ms:.1f} ms; {len(rows2)} units, every file's doc ids = the metadata's",
              flush=True)

        # Queries from the tree's own function names and docstrings.
        rng = np.random.default_rng(0)
        pool = [r for r in rows2 if r["unit_type"] in ("function", "method") and r["docstring"]]
        picks = rng.choice(len(pool), size=min(n_queries, len(pool)), replace=False)
        queries = [f"{pool[i]['name'].replace('_', ' ')} "
                   f"{' '.join(pool[i]['docstring'].split()[:8])}" for i in sorted(picks)]
        searcher = Searcher(idx, enc, device=device)
        searcher.search(queries[0])  # warm-up (loads the index)
        for label, opts in CS_OPTIONS:
            lat, legs = [], {}
            for q in queries if not opts else queries[:CS_FILTER_QUERIES]:
                stages = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                found = searcher.search(q, SearchOptions(**opts), stages=stages)
                lat.append(1e3 * (time.perf_counter() - t0))
                if not found:
                    raise AssertionError(f"codesearch [{label}]: {q!r} found nothing")
                for n, s in stages.items():
                    legs.setdefault(n, []).append(1e3 * s)
            print(f"codesearch search [{label}]: {len(lat)} queries, p50 "
                  f"{statistics.median(lat):.2f} ms, p95 {np.percentile(lat, 95):.2f} ms; "
                  f"median ms by leg: "
                  f"{', '.join(f'{n} {statistics.median(v):.2f}' for n, v in legs.items())}",
                  flush=True)
        if mk.maxsim_grid_scores.launches or mk.maxsim_grid_scores_int8i.launches:
            raise AssertionError("code search launched a MaxSim kernel on an unpinned index")

        # The card's hits against a CPU search_batch of the same index and
        # the same query embeddings.
        class FixedQueries:
            def __init__(self, embs):
                self.embs = dict(zip(queries[:CS_CPU_QUERIES], embs))

            def encode_queries(self, qs):
                return [self.embs[q] for q in qs]

        fixed = FixedQueries(enc.encode_queries(queries[:CS_CPU_QUERIES]))
        card_searcher = Searcher(idx, fixed, device=device)
        cpu_searcher = Searcher(idx, fixed, device="cpu")
        t0 = time.perf_counter()
        for i, q in enumerate(queries[:CS_CPU_QUERIES]):
            same_hits(card_searcher.search(q), cpu_searcher.search(q), CS_RTOL,
                      f"codesearch card vs CPU, query {i}")
        print(f"codesearch: the card's hits = a CPU search_batch's on the same index and query "
              f"embeddings for {CS_CPU_QUERIES} queries (file, name, line; scores within "
              f"{CS_RTOL}; {time.perf_counter() - t0:.1f} s on the CPU)", flush=True)

        # The CLI as a subprocess, over the model directory.
        env = dict(os.environ, CGREP_CONFIG_DIR=os.path.join(CS_DIR, "cfg"))
        cmd = [sys.executable, "-m", "nextplaid_tpu_torch.codesearch.cli", "--device", device.type,
               "--path", proj, "--index-dir", idx, "--model", model_dir, "--no-update",
               "--json", "-k", "10", "--", queries[1]]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                             timeout=600)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"cgrep exited {out.returncode}: {out.stderr[-2000:]}")
        got = json.loads(out.stdout)
        want = searcher.search(queries[1], SearchOptions(top_k=10))
        if [(h["file"], h["name"], h["line"]) for h in got] != [
                (h.file, h.name, h.line) for h in want] or not np.allclose(
                [h["score"] for h in got], [round(h.score, 4) for h in want], atol=CS_RTOL):
            raise AssertionError(f"cgrep's hits differ from the in-process search: {got[:3]}")
        print(f"codesearch cli: python -m nextplaid_tpu_torch.codesearch.cli --device {device.type} "
              f"--json over the model directory: {len(got)} hits = the in-process search's, "
              f"{cli_s:.2f} s wall; the phase {time.perf_counter() - t_phase:.1f} s; MaxSim "
              f"kernel launches 0 (exhaustive scan)", flush=True)
    finally:
        shutil.rmtree(CS_DIR, ignore_errors=True)


SHARD_DIR = os.path.join(ROOT, "build", "chip_smoke_sharded")
SHARDS = 4  # shards of the in-process mesh, all on the one card
SHARD_CAPACITY = 1.5
SHARD_PASSES = 3
# Sharded vs single-card top-10: the same kernel (or scan) over the same
# rows under other launch plans and batch shapes. Scores (up to ~35 over 32
# query tokens) within this absolute bound, and no relative slack.
SHARD_ATOL = 4e-3
# One Lloyd iteration from one init: the same assignments (the same chunked
# f32 argmax), the cluster sums added in another order.
LLOYD_ATOL = 1e-5
RANK_TIMEOUT_S = 300


def warm_passes(fn, passes):
    """`fn()` once to warm up, then `passes` timed runs, each ended by a
    sync. Returns (the last run's result, the runs' seconds)."""
    fn()
    out, secs = None, []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def qps_line(n, secs):
    qps = [n / x for x in secs]
    return f"p50 {statistics.median(qps):.1f} QPS (min {min(qps):.1f}, max {max(qps):.1f})"


def assert_same_shard_topk(got, want, label):
    """`assert_same_topk` at SHARD_ATOL; returns the largest score gap."""
    return assert_same_topk(got, want, 0.0, label, atol=SHARD_ATOL)


def take_launches(kernel):
    """The kernel's launches since the last reset; resets the count."""
    n, kernel.launches = kernel.launches, 0
    return n


def rank_worker(device, path, queries_path, out_path, local_shards):
    """One rank of phase (e), in its own process: joins the mesh from the
    NEXT_PLAID_* environment variables on `device`, shards the index's bf16
    grid over its `local_shards` shards there and searches the saved
    queries; writes its backend, launches, wall and results to `out_path`."""
    import torch.distributed as dist

    from nextplaid_tpu_torch.index import SearchParameters
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk
    from nextplaid_tpu_torch.parallel import (
        ShardedGridIndex, init_distributed, make_mesh, search_batch_sharded_grid,
    )

    if not init_distributed(device=device):
        raise AssertionError("the NEXT_PLAID_* environment did not form a process group")
    mesh = make_mesh(devices=[device] * int(local_shards))
    sg = ShardedGridIndex.shard_grid_only(path, mesh, "bf16")
    queries = list(np.load(queries_path))
    params = SearchParameters(top_k=10)
    search_batch_sharded_grid(sg, queries, params)  # warm-up
    take_launches(mk.maxsim_grid_scores)
    t0 = time.perf_counter()
    results = search_batch_sharded_grid(sg, queries, params)  # ends in a copy to the host
    wall = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"rank": mesh.rank, "world_size": mesh.world_size, "shards": mesh.size,
                   "backend": dist.get_backend(), "launches": take_launches(mk.maxsim_grid_scores),
                   "wall_s": wall, "results": [[r.passage_ids, r.scores] for r in results]}, f)
    dist.destroy_process_group()


def run_ranks(device, path, queries, out_dir):
    """Phase (e): two processes x 2 shards on `device` (gloo: the ranks
    share the card) and one process x 4 shards (NCCL on a card of its own),
    all three started together. Returns each group's outputs by rank; a rank
    that fails or outlives RANK_TIMEOUT_S fails the phase."""
    q_path = os.path.join(out_dir, "queries.npy")
    np.save(q_path, np.stack(queries))
    groups = {"gloo": (2, SHARDS // 2, free_port()), "nccl": (1, SHARDS, free_port())}
    env = {k: v for k, v in os.environ.items() if not k.startswith("NEXT_PLAID_")}
    procs = []
    for group, (world, local, port) in groups.items():
        for rank in range(world):
            out = os.path.join(out_dir, f"{group}_{rank}.json")
            procs.append((group, rank, out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(device), path, q_path,
                 out, str(local)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=dict(env, NEXT_PLAID_COORDINATOR=f"127.0.0.1:{port}",
                         NEXT_PLAID_NUM_PROCESSES=str(world), NEXT_PLAID_PROCESS_ID=str(rank)))))
    outputs = {}
    try:
        for group, rank, out, proc in procs:
            log, _ = proc.communicate(timeout=RANK_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"sharded (e): {group} rank {rank} failed:\n{log[-3000:]}")
            with open(out) as f:
                outputs.setdefault(group, []).append(json.load(f))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outputs


def as_results(pairs):
    import types

    return [types.SimpleNamespace(passage_ids=ids, scores=scores) for ids, scores in pairs]


def sharded_phase(device, mk, src_path, topics, queries):
    """This slice's path: doc-range sharding at SciFact scale on an
    in-process mesh of SHARDS shards on the one card. (a) `shard_grid_only`
    bf16 and int8 and `search_batch_sharded_grid` over the 320 queries
    against the single-card pinned grid; (b) `ShardedIndex` (capacity 1.5):
    exact against the single-card scan, staged recall at the default and
    "quality" points against the single card's, one 32-doc batch appended to
    it (then `refresh_ivf`) and to both grids, each against a fresh shard of
    the updated index; (c) `lloyd_sharded` against `lloyd` on the build's
    k-means sample; (e) the grid over two processes x 2 shards (gloo) and
    one process x 4 shards (NCCL); (f) the service's serve modes "sharded"
    and "sharded_grid". Returns the two kernels' numbers of the phase."""
    from nextplaid_tpu_torch.api.inprocess import InProcessServer
    from nextplaid_tpu_torch.api.models import IndexConfigStored
    from nextplaid_tpu_torch.client import NextPlaidClient
    from nextplaid_tpu_torch.client.client import _doc_payload
    from nextplaid_tpu_torch.index import (
        DeviceIndex, SearchParameters, UpdateConfig, search_batch, update_or_create,
    )
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.ops.kmeans import assign_chunk_rows, lloyd, num_partitions_heuristic
    from nextplaid_tpu_torch.parallel import (
        HostIndexData, ShardedGridIndex, ShardedIndex, lloyd_sharded, make_mesh,
        search_batch_sharded, search_batch_sharded_grid,
    )
    from nextplaid_tpu_torch.parallel import sharded as ps
    from nextplaid_tpu_torch.storage.npy import atomic_write_json, load_json

    t_phase = time.perf_counter()
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    path = os.path.join(SHARD_DIR, "scifact")
    kernels = {"bf16": mk.maxsim_grid_scores, "int8": mk.maxsim_grid_scores_int8i}
    plains = {"bf16": mk.maxsim_grid_scores_reference,
              "int8": mk.maxsim_grid_scores_int8i_reference}
    out = {dt: {"sharded_launches": 0, "sharded_max_abs_err": 0.0} for dt in kernels}
    params = SearchParameters(top_k=10)
    try:
        shutil.copytree(src_path, path)
        n0 = load_json(os.path.join(path, "metadata.json"))["num_documents"]
        mesh = make_mesh(devices=[device] * SHARDS)
        q_arr, _ = _pad_queries(queries, 128)
        q_dev = torch.from_numpy(q_arr).to(device)
        tq = q_arr.shape[1]
        gaps = []  # the largest score gap of every top-10 comparison
        for k in kernels.values():
            take_launches(k)

        # (a) sharded grids, both kernels, against the single-card pinned grid.
        grids = {}
        for dtype, kernel in kernels.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sg = ShardedGridIndex.shard_grid_only(path, mesh, dtype)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            single = DeviceIndex.load(path, device=device).with_token_grid(dtype=dtype)
            want = search_batch(single, queries, params)
            del single
            search_batch_sharded_grid(sg, queries, params)  # warm-up
            take_launches(kernel)
            pass_s = []
            for _ in range(SHARD_PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = search_batch_sharded_grid(sg, queries, params)
                pass_s.append(time.perf_counter() - t0)
            launches = take_launches(kernel)
            if launches < SHARD_PASSES * SHARDS:
                raise AssertionError(f"sharded (a) {dtype}: {launches} kernel launches in "
                                     f"{SHARD_PASSES} passes over {SHARDS} shards")
            out[dtype]["sharded_launches"] += launches
            check_results(got, NUM_QUERIES)
            gaps.append(assert_same_shard_topk(got, want,
                                               f"sharded (a) {dtype} vs the single-card grid"))
            qflat = q_dev.reshape(-1, 128)
            args = ((qflat.to(torch.bfloat16), sg.grids[0], sg.doclens[0], tq) if dtype == "bf16"
                    else (*quantize_queries_int8(qflat), sg.grids[0], sg.scales[0], tq))
            err = check_kernel(kernel, plains[dtype], args,
                               f"sharded {dtype} shard 0, {q_arr.shape[0]}q x {sg.rows} rows")
            take_launches(kernel)
            bound_ms, bound_by = (maxsim_bound(*args)[:2] if dtype == "bf16" else maxsim_bound_int8(
                args[0], [sg.grids[0]], [sg.scales[0]], q_arr.shape[0]))
            out[dtype]["sharded_max_abs_err"] = err
            on_dev = {mesh.devices[0]: q_dev}
            shard_ms = [time_ms(lambda i=i: ps.shard_grid_scores(sg, i, q_dev), reps=10)
                        for i in range(SHARDS)]
            tiles = ps.grid_tiles(sg, on_dev, 10)
            merge_ms = time_ms(lambda: ps.merge_tiles(mesh, tiles, 10), reps=20)
            take_launches(kernel)
            qps = [NUM_QUERIES / x for x in pass_s]
            out[dtype].update(sharded_shard_ms=shard_ms, sharded_merge_ms=merge_ms,
                              sharded_shard_bound_ms=bound_ms, sharded_shard_bound_by=bound_by)
            print(f"sharded (a) [{dtype} grid, {SHARDS} shards on one card]: shard_grid_only "
                  f"{load_s:.2f} s, {sg.rows} rows x Td {sg.grid_td} a shard; {NUM_QUERIES} queries "
                  f"p50 {statistics.median(qps):.1f} QPS (min {min(qps):.1f}, max {max(qps):.1f}); "
                  f"per-shard kernel {', '.join(f'{x:.3f}' for x in shard_ms)} ms (shard 0's bound "
                  f"{bound_ms:.3f} ms, {bound_by}), merge {merge_ms:.3f} ms; top-10 = the "
                  f"single-card pinned grid's; kernel launches {launches}", flush=True)
            grids[dtype] = (sg, got)

        # (b) the compressed index: exact, staged, appends.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        si = ShardedIndex.shard(HostIndexData.load(path), mesh, SHARD_CAPACITY)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        unpinned = DeviceIndex.load(path, device=device)
        exact = SearchParameters(top_k=10, mode="exact")
        oracle = search_batch(unpinned, queries, exact)
        got, pass_s = warm_passes(lambda: search_batch_sharded(si, queries, exact), SHARD_PASSES)
        exact_qps = qps_line(NUM_QUERIES, pass_s)
        gaps.append(assert_same_shard_topk(got, oracle, "sharded (b) exact vs the single-card scan"))
        staged = []
        for label, p in (("default", SearchParameters(top_k=10, mode="staged")),
                         ('"quality"', SearchParameters.preset("quality", top_k=10, mode="staged"))):
            r_single = recall_at_10(search_batch(unpinned, queries, p), oracle)
            got, pass_s = warm_passes(lambda p=p: search_batch_sharded(si, queries, p),
                                      SHARD_PASSES)
            check_results(got, NUM_QUERIES)
            r_sharded = recall_at_10(got, oracle)
            if r_sharded < r_single - RECALL_SLACK:
                raise AssertionError(f"sharded (b) staged {label}: recall@10 {r_sharded} < "
                                     f"single-card {r_single} - {RECALL_SLACK}")
            staged.append(f"{label} {r_sharded:.4f} (single card {r_single:.4f}, "
                          f"{qps_line(NUM_QUERIES, pass_s)})")
        del unpinned
        print(f"sharded (b) [ShardedIndex, {SHARDS} shards, capacity {SHARD_CAPACITY}; "
              f"{NUM_QUERIES} queries, one warm-up pass, then {SHARD_PASSES} timed]: shard "
              f"{shard_s:.2f} s; exact top-10 = the single-card scan's ({exact_qps}); staged "
              f"recall@10 vs the f32 oracle {'; '.join(staged)}", flush=True)

        docs = new_docs(topics, MUT_BATCH, seed=900)
        info = {}
        update_or_create(docs, path, update_config=UpdateConfig(), info_out=info, device=device)
        if info.get("mode") != "buffer":
            raise AssertionError(f"sharded (b): the 32-doc update ran in mode {info.get('mode')}")
        encoded = info["encoded"]
        own = [d[:32] for d in docs]
        q_check = queries[:64] + own
        n_q = len(q_check) - MUT_BATCH
        own_ids = list(range(n0, n0 + MUT_BATCH))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        si2 = si.append_batch(*encoded)
        si2 = si2.refresh_ivf() if si2 is not None else None
        torch.cuda.synchronize()
        append_ms = {"ShardedIndex": 1e3 * (time.perf_counter() - t0)}
        if si2 is None:
            raise AssertionError("sharded (b): ShardedIndex.append_batch could not append in place")
        fresh = ShardedIndex.shard(HostIndexData.load(path), mesh, SHARD_CAPACITY)
        want = search_batch_sharded(fresh, q_check, exact)
        gaps.append(assert_same_shard_topk(search_batch_sharded(si2, q_check, exact), want,
                                           "sharded (b) appended ShardedIndex vs a fresh shard"))
        p_staged = SearchParameters(top_k=10, mode="staged")
        r_app = recall_at_10(search_batch_sharded(si2, q_check, p_staged), want)
        r_fresh = recall_at_10(search_batch_sharded(fresh, q_check, p_staged), want)
        if r_app < r_fresh - RECALL_SLACK:
            raise AssertionError(f"sharded (b): staged recall after refresh_ivf {r_app} < "
                                 f"a fresh shard's {r_fresh} - {RECALL_SLACK}")
        del fresh, si, si2
        for dtype, kernel in kernels.items():
            sg = grids[dtype][0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sg2 = sg.append_batch(*encoded)
            torch.cuda.synchronize()
            append_ms[dtype] = 1e3 * (time.perf_counter() - t0)
            if sg2 is None or sg2.grids[0].data_ptr() != sg.grids[0].data_ptr():
                raise AssertionError(f"sharded (b): the {dtype} grid was not appended in place")
            fresh = ShardedGridIndex.shard_grid_only(path, mesh, dtype)
            take_launches(kernel)
            got = search_batch_sharded_grid(sg2, q_check, params)
            out[dtype]["sharded_launches"] += take_launches(kernel)
            gaps.append(assert_same_shard_topk(
                got, search_batch_sharded_grid(fresh, q_check, params),
                f"sharded (b) appended {dtype} grid vs a fresh shard"))
            take_launches(kernel)
            if [r.passage_ids[0] for r in got[n_q:]] != own_ids:
                raise AssertionError(f"sharded (b) {dtype}: a new doc is not its own query's top hit")
            grids[dtype] = (sg, grids[dtype][1])
            del fresh, sg2
        print(f"sharded (b) appends of {MUT_BATCH} docs in place: ShardedIndex + refresh_ivf "
              f"{append_ms['ShardedIndex']:.2f} ms (exact top-10 = a fresh shard's; staged recall "
              f"{r_app:.4f}, fresh {r_fresh:.4f}); ShardedGridIndex bf16 {append_ms['bf16']:.2f} ms, "
              f"int8 {append_ms['int8']:.2f} ms (top-10 = a fresh shard's, every new doc its own "
              f"query's top hit)", flush=True)

        # (c) sharded k-means on the build's sample, from the build's init.
        tokens, _ = make_corpus_device(make_doclens(n0), device)
        k = num_partitions_heuristic(float(tokens.shape[0]))
        init = tokens[torch.from_numpy(
            np.random.default_rng(42).permutation(tokens.shape[0])[:k]).to(device)]
        diffs, times = {}, {}
        for iters in (1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single = lloyd(tokens, init, iters=iters,
                           assign_chunk=assign_chunk_rows(k, floor=512)).cpu().numpy()
            single_s = time.perf_counter() - t0
            single /= np.maximum(np.linalg.norm(single, axis=1, keepdims=True), 1e-12)
            t0 = time.perf_counter()
            sharded = lloyd_sharded(tokens, init, iters=iters, mesh=mesh)
            times[iters] = (single_s, time.perf_counter() - t0)
            gap = np.abs(sharded - single)
            diffs[iters] = (float(gap.max()), int((gap.max(axis=1) > 1e-4).sum()))
        del tokens, init
        if not diffs[1][0] <= LLOYD_ATOL:
            raise AssertionError(f"sharded (c): one sharded Lloyd iteration is {diffs[1][0]} from "
                                 f"lloyd's (tolerance {LLOYD_ATOL})")
        print(f"sharded (c) lloyd_sharded over {SHARDS} shards, K {k}, {make_doclens(n0).sum()} "
              f"tokens: 1 iteration max |sharded - lloyd| {diffs[1][0]:.3e} (tolerance "
              f"{LLOYD_ATOL:.0e}), {times[1][1]:.2f} s vs {times[1][0]:.2f} s; 4 iterations (the "
              f"build's) {diffs[4][0]:.3e}, {diffs[4][1]} of {k} centroids beyond 1e-4 (near-tie "
              f"reassignments after sums in another order), {times[4][1]:.2f} s vs "
              f"{times[4][0]:.2f} s", flush=True)

        # (e) several processes on the card.
        ranks = run_ranks(device, src_path, queries, SHARD_DIR)  # the index of (a)
        want = grids["bf16"][1]
        # The backend rule: NCCL when every rank has a card of its own.
        own_card = "nccl" if device.type == "cuda" else "gloo"
        for group, backend in (("gloo", "gloo"), ("nccl", own_card)):
            for r in ranks[group]:
                if r["backend"] != backend or r["launches"] < r["shards"] // r["world_size"]:
                    raise AssertionError(f"sharded (e) {group}: rank {r['rank']} ran {r['backend']} "
                                         f"with {r['launches']} kernel launches")
                gaps.append(assert_same_shard_topk(
                    as_results(r["results"]), want,
                    f"sharded (e) {group} rank {r['rank']} vs in-process"))
        e_launches = sum(r["launches"] for g in ranks.values() for r in g)
        out["bf16"]["sharded_launches"] += e_launches
        walls = {g: ", ".join(f"{r['wall_s']:.3f}" for r in ranks[g]) for g in ranks}
        print(f"sharded (e): 2 processes x {SHARDS // 2} shards on one card over gloo (each "
              f"rank's search of {NUM_QUERIES} queries {walls['gloo']} s) and 1 process x {SHARDS} "
              f"shards over NCCL ({walls['nccl']} s): merged top-10 on every rank = in-process; "
              f"bf16 kernel launches {e_launches}", flush=True)

        # (f) the service's sharded serve modes.
        svc_dir = os.path.join(SHARD_DIR, "service")
        modes = {"sharded": ShardedIndex, "sharded_grid": ShardedGridIndex}
        for mode in modes:
            dst = os.path.join(svc_dir, mode)
            shutil.copytree(path, dst)
            atomic_write_json(os.path.join(dst, "config.json"),
                              IndexConfigStored(serve_mode=mode).model_dump())
        n1 = n0 + MUT_BATCH
        loaders = {"sharded": (ShardedIndex, "shard", search_batch_sharded),
                   "sharded_grid": (ShardedGridIndex, "shard_grid_only", search_batch_sharded_grid)}
        server = InProcessServer(svc_dir, None, device)
        try:
            client = NextPlaidClient(server.url, timeout=600)
            lines = []
            for mode, (cls, loader, fn) in loaders.items():
                take_launches(kernels["int8"])
                body = client.search(mode, queries[:64], top_k=10)
                served = server.state.served(mode)
                if not isinstance(served, cls) or served.n_shards != torch.cuda.device_count():
                    raise AssertionError(f"sharded (f) {mode}: serving {type(served).__name__}")
                gaps.append(assert_same_shard_topk(
                    http_results(body), fn(served, queries[:64], params),
                    f"sharded (f) {mode} over HTTP vs in-process"))
                out["int8"]["sharded_launches"] += take_launches(kernels["int8"])
                # Count the reloads the ingest makes, as
                # tests/test_device_append.py's sharded_grid ingest test does.
                real, reloads = getattr(cls, loader).__func__, []
                setattr(cls, loader, classmethod(
                    lambda c, *a, **kw: reloads.append(1) or real(c, *a, **kw)))
                try:
                    docs = new_docs(topics, MUT_BATCH, seed=950)
                    t0 = time.perf_counter()
                    client._request("POST", f"/indices/{mode}/documents",
                                    json={"documents": [_doc_payload(d) for d in docs]})
                    post_ms = 1e3 * (time.perf_counter() - t0)
                finally:
                    setattr(cls, loader, classmethod(real))
                after = server.state.served(mode)
                first = (lambda x: x.grids[0]) if cls is ShardedGridIndex else (
                    lambda x: x.shards[0].codes)
                if (reloads or after is served or after.num_documents != n1 + MUT_BATCH
                        or first(after).data_ptr() != first(served).data_ptr()):
                    raise AssertionError(f"sharded (f) {mode}: the ingest batch was not appended in "
                                         f"place ({len(reloads)} reloads)")
                body = client.search(mode, [d[:32] for d in docs], top_k=10)
                if [r.passage_ids[0] for r in http_results(body)] != list(range(n1, n1 + MUT_BATCH)):
                    raise AssertionError(f"sharded (f) {mode}: a new doc is not its own query's top hit")
                out["int8"]["sharded_launches"] += take_launches(kernels["int8"])
                lines.append(f"{mode} ({type(served).__name__}, {served.n_shards} shard) top-10 = "
                             f"in-process, /documents of {MUT_BATCH} appended in place in "
                             f"{post_ms:.1f} ms (0 reloads)")
        finally:
            server.stop()
        print(f"sharded (f) the service: {'; '.join(lines)}; the phase "
              f"{time.perf_counter() - t_phase:.1f} s; largest score gap of the phase's "
              f"{len(gaps)} top-10 comparisons {max(gaps):.3e} (bound {SHARD_ATOL:.0e})", flush=True)
        for dtype in kernels:
            if not out[dtype]["sharded_launches"]:
                raise AssertionError(f"the sharded phase launched the {dtype} kernel no time")
        return out
    finally:
        shutil.rmtree(SHARD_DIR, ignore_errors=True)


# Harness phase: the entry points outside the package, each run as a user
# runs it. (a) and (b) run in this process; (c)-(f) are the scripts under
# scripts/, each a child process with --device cuda whose JSON is parsed.
HARNESS_DIR = os.path.join(ROOT, "build", "chip_smoke_harness")
HARNESS_TIMEOUT_S = 240
ENTRY_TOL = 1e-4  # the same pipeline on the same inputs: equal up to f32 sum order
STRESS_CYCLES = 12


def start_script(name, *args, env=None):
    """scripts/<name> with --device cuda, as a child process."""
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", name), "--device", "cuda", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def finish_script(proc, name, t0):
    """Waits for `proc`; fails on a non-zero exit. Returns (its JSON lines,
    its wall seconds from `t0`)."""
    try:
        out, err = proc.communicate(timeout=HARNESS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"harness: {name} outlived {HARNESS_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"harness: {name} exited {proc.returncode}: {err[-3000:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")], wall


def harness_phase(device, mk, smi, topics):
    """(a) `entry()`'s staged step against `search_batch`; (b)
    `dryrun_multichip(4)` on 4 shards of the card; (c) scripts/eval_torch_recall.py
    on the SciFact index of the earlier phases (SERVICE_SRC as BENCH_IDX);
    then, as five concurrent processes, (d) scripts/eval_torch_beir.py
    --smoke in local and api modes and scripts/fetch_torch_eval_assets.py
    --offline, (e) scripts/eval_torch_codesearch.py --smoke and (f)
    scripts/run_torch_stress_acceptance.py. Each kernel is held against its
    plain version at the arguments (a)-(d) give it: (a)'s stage 4, (b)'s
    int8 grid shards, (c)'s exact grid and largest staged union, (d)'s
    smoke grid (rebuilt here from the script's corpus and encoder). Returns
    the two kernels' launches of (a)-(d), this process's counts and the
    children's, and their largest differences from the plain versions."""
    from nextplaid_tpu_torch.entry import dryrun_multichip, entry
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, QueryResult, SearchParameters, create_index, search_batch,
    )
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8

    t_phase = time.perf_counter()
    kernels = {"bf16": mk.maxsim_grid_scores, "int8": mk.maxsim_grid_scores_int8i}
    plains = {"bf16": mk.maxsim_grid_scores_reference,
              "int8": mk.maxsim_grid_scores_int8i_reference}
    launches = {"bf16": 0, "int8": 0}
    errs = {"bf16": [], "int8": []}

    def check(dtype, args, label):
        errs[dtype].append(check_kernel(kernels[dtype], plains[dtype], args, f"harness {label}"))
        take_launches(kernels[dtype])  # comparison launches: not the path's

    procs = {}
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    os.makedirs(HARNESS_DIR)
    try:
        # (a) The staged step as entry() gives it, and with the centroid
        # threshold off: at the default 0.4 the example queries (random unit
        # rows) select no cell, so the step returns no hit, as the JAX one.
        for k in kernels.values():
            take_launches(k)
        fn, args = entry(device, path=os.path.join(HARNESS_DIR, "entry_idx"))
        index, queries, qmask = args
        valid = [q[m].cpu().numpy() for q, m in zip(queries, qmask)]
        lines, steps = [], 0
        for threshold in (0.4, None):
            shapes = dataclasses.replace(fn.keywords["shapes"], threshold=threshold)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, scores, _ = fn.func(*args, subset_mask=None, shapes=shapes)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0)
            steps += 1
            ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
            got = [QueryResult(i, [int(x) for x in row[row >= 0]], [float(s) for s in srow[row >= 0]])
                   for i, (row, srow) in enumerate(zip(ids, scores))]
            want = search_batch(index, valid, SearchParameters(
                top_k=5, n_full_scores=64, mode="staged", centroid_score_threshold=threshold))
            gap = assert_same_topk(got, want, ENTRY_TOL, f"harness (a) threshold {threshold}")
            hits = sum(len(r.passage_ids) for r in got)
            if threshold is None and hits != 5 * len(got):
                raise AssertionError(f"harness (a): {hits} hits without the threshold")
            lines.append(f"threshold {threshold}: {hits} hits, step {step_ms:.2f} ms, largest "
                         f"score gap {gap:.3e}")
        a_launches = {dt: take_launches(k) for dt, k in kernels.items()}
        if a_launches["bf16"] < steps:
            raise AssertionError(f"harness (a): stage 4 launched the bf16 kernel "
                                 f"{a_launches['bf16']} times in {2 * steps} staged batches")
        print(f"harness (a) entry(): staged step = search_batch (tie rule, tolerance {ENTRY_TOL}); "
              f"{'; '.join(lines)}; kernel launches {a_launches}", flush=True)
        for threshold in (0.4, None):
            shapes = dataclasses.replace(fn.keywords["shapes"], threshold=threshold)
            s4, n_union = stage4_kernel_args(index, queries, qmask, shapes)
            check("bf16", s4, f"(a) stage 4, threshold {threshold}: union {n_union} docs, grid "
                              f"{tuple(s4[1].shape)}, {queries.shape[0]}q x {s4[3]} tokens")

        # (b) The multi-device dry run on 4 shards of the card.
        t0 = time.perf_counter()
        grid_in = {}
        summary = dryrun_multichip(SHARDS, device, workdir=HARNESS_DIR, grid_out=grid_in)
        dry_s = time.perf_counter() - t0
        flags = dict(re.findall(r"(\S+)=(\[[^\]]*\]|True|False|\d+)", summary))
        if not summary.startswith("DRYRUN VERIFIED:") or "False" in flags.values() or len(flags) != 10:
            raise AssertionError(f"harness (b): {summary}")
        b_launches = {dt: take_launches(k) for dt, k in kernels.items()}
        if b_launches["int8"] < SHARDS:
            raise AssertionError(f"harness (b): the int8 grid shards launched {b_launches['int8']}")
        print(f"harness (b) dryrun_multichip({SHARDS}): {dry_s:.2f} s; kernel launches "
              f"{b_launches}", flush=True)
        sg = grid_in["sg"]
        q_arr, _ = S._pad_queries(grid_in["queries"], sg.dim)
        for i, grid in enumerate(sg.grids):
            qi8, qs = quantize_queries_int8(torch.from_numpy(q_arr.reshape(-1, sg.dim)).to(grid.device))
            check("int8", (qi8, qs, grid, sg.scales[i], q_arr.shape[1]),
                  f"(b) int8 grid shard {i}: {q_arr.shape[0]}q x {q_arr.shape[1]} tokens over "
                  f"{tuple(grid.shape)}")
        del sg, grid_in

        # (c) The recall sweep on the SciFact index, alone on the card. The
        # script builds its corpus anew when BENCH_IDX holds no index.
        if not os.path.exists(os.path.join(SERVICE_SRC, "metadata.json")):
            raise AssertionError(f"harness (c): no SciFact index at {SERVICE_SRC} to reuse")
        t0 = time.perf_counter()
        proc = procs["recall"] = start_script("eval_torch_recall.py",
                                              env=dict(os.environ, BENCH_IDX=SERVICE_SRC))
        sweep, wall = finish_script(proc, "eval_torch_recall.py", t0)
        configs = [ln["config"] for ln in sweep]
        if len(sweep) != 6 or not configs[0].startswith("exact bf16"):
            raise AssertionError(f"harness (c): {configs}")
        if sweep[0]["recall_at_10"] < MIN_RECALL:
            raise AssertionError(f"harness (c): exact bf16 recall@10 {sweep[0]['recall_at_10']} "
                                 f"< {MIN_RECALL}")
        c_launches = {dt: sum(ln["launches"][dt] for ln in sweep) for dt in kernels}
        if any(ln["timed_launches"]["bf16"] < 3 for ln in sweep):
            raise AssertionError(f"harness (c): bf16 launches {[ln['timed_launches'] for ln in sweep]}")
        points = "; ".join(f"{ln['config']}: recall@10 {ln['recall_at_10']:.4f}, p50 "
                           f"{ln['qps']:.1f} QPS" for ln in sweep)
        print(f"harness (c) eval_torch_recall.py [{smi}]: {points} (128 queries in batches of 64, "
              f"median of 3 passes); {wall:.1f} s wall; kernel launches {c_launches}, the "
              f"warm-ups included (timed passes "
              f"{ {dt: sum(ln['timed_launches'][dt] for ln in sweep) for dt in kernels} })",
              flush=True)
        # The sweep's first batch: the script's queries (its corpus is the
        # SciFact phase's, topics and all).
        batch = make_queries(topics, num_queries=128)[:64]
        sci = DeviceIndex.load(SERVICE_SRC, device=device)
        q_arr, q_mask = S._pad_queries(batch, sci.dim)
        shapes = S.PipelineShapes.derive(sci, SearchParameters(top_k=10, mode="staged",
                                                               n_ivf_probe=16), 64, q_arr.shape[1])
        s4, n_union = stage4_kernel_args(sci, torch.from_numpy(q_arr).to(device),
                                         torch.from_numpy(q_mask).to(device), shapes)
        check("bf16", s4, f"(c) staged nprobe=16 stage 4: union {n_union} docs, grid "
                          f"{tuple(s4[1].shape)}, 64q")
        sci = sci.with_token_grid()
        check("bf16", exact_grid_args(sci, batch), f"(c) exact bf16 grid {tuple(sci.token_grid.shape)}, 64q")
        del sci, s4
        # (d)'s smoke grid, as eval_torch_beir.py --smoke --mode local builds it.
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import eval_torch_beir
        from nextplaid_tpu_torch.eval import load_beir, make_synthetic_beir

        smoke_dir = os.path.join(HARNESS_DIR, "beir_smoke")
        make_synthetic_beir(smoke_dir, num_docs=64, num_queries=8)
        docs, bq, _ = load_beir(smoke_dir, split="test")
        enc = eval_torch_beir.HashEncoder()
        create_index(enc.encode_documents([eval_torch_beir.doc_text(d) for d in docs]),
                     os.path.join(smoke_dir, "corpus"), IndexConfig(nbits=4), device=device)
        smoke = DeviceIndex.load(os.path.join(smoke_dir, "corpus"), device=device).with_token_grid()
        check("bf16", exact_grid_args(smoke, enc.encode_queries(list(bq.values()))),
              f"(d) beir smoke grid {tuple(smoke.token_grid.shape)}, {len(bq)}q")
        del smoke

        # (d)-(f) Five children at once: their times share the card and
        # the host.
        t0 = time.perf_counter()
        procs.clear()
        for key, *argv in (
            ("beir local", "eval_torch_beir.py", "--smoke", "--mode", "local"),
            ("beir api", "eval_torch_beir.py", "--smoke", "--mode", "api"),
            ("offline", "fetch_torch_eval_assets.py", "--offline"),
            ("codesearch", "eval_torch_codesearch.py", "--smoke"),
            ("stress", "run_torch_stress_acceptance.py", str(STRESS_CYCLES)),
        ):
            procs[key] = start_script(*argv)
        done = {key: finish_script(p, key, t0) for key, p in procs.items()}
        d_launches = {dt: 0 for dt in kernels}
        parts = []
        for key in ("beir local", "beir api"):
            res, wall = done[key]
            m = res[-1]["metrics"]
            if m["ndcg@10"] < 0.9:
                raise AssertionError(f"harness (d) {key}: {m}")
            for dt in kernels:
                d_launches[dt] += res[-1]["kernel_launches"][dt]
            parts.append(f"{key} ndcg@10 {m['ndcg@10']:.4f} recall@10 {m['recall@10']:.4f} "
                         f"({wall:.1f} s)")
        rec, wall = done["offline"]
        for mode in ("local", "api"):
            m = rec[-1]["results"][mode]["metrics"]
            if m["ndcg@10"] < 0.85 or m["recall@10"] < 0.95:
                raise AssertionError(f"harness (d) offline {mode}: {m}")
            parts.append(f"offline {mode} ndcg@10 {m['ndcg@10']:.4f} recall@10 "
                         f"{m['recall@10']:.4f}")
        for dt in kernels:
            d_launches[dt] += rec[-1]["kernel_launches"][dt]
        parts[-1] += f" ({wall:.1f} s)"
        if d_launches["bf16"] < 3:
            raise AssertionError(f"harness (d): bf16 launches {d_launches}")
        print(f"harness (d) eval_torch_beir.py --smoke, fetch_torch_eval_assets.py --offline: "
              f"{'; '.join(parts)}; kernel launches {d_launches}", flush=True)
        cs, wall = done["codesearch"]
        if cs[-1]["metrics"]["ndcg@10"] < 0.9:
            raise AssertionError(f"harness (e): {cs[-1]['metrics']}")
        print(f"harness (e) eval_torch_codesearch.py --smoke: {cs[-1]['metrics']}, "
              f"{cs[-1]['units_indexed']} units ({wall:.1f} s)", flush=True)
        st, wall = done["stress"]
        st = st[-1]
        if st["cycles"] != STRESS_CYCLES or not st["count_sync_verified_every_op"]:
            raise AssertionError(f"harness (f): {st}")
        print(f"harness (f) run_torch_stress_acceptance.py {STRESS_CYCLES} [{smi}]: "
              f"{st['elapsed_seconds']:.2f} s in the script ({wall:.1f} s wall), "
              f"{st['total_documents_added']} added, {st['total_documents_deleted']} deleted in "
              f"{st['delete_operations']} deletes, {st['final_documents']} final; every check "
              f"held; (d)-(f) ran as {len(procs)} processes at once, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for dt in kernels:
            launches[dt] = a_launches[dt] + b_launches[dt] + c_launches[dt] + d_launches[dt]
        print(f"harness: the phase {time.perf_counter() - t_phase:.1f} s; kernel launches of "
              f"(a)-(d) {launches}; kernel checks at their arguments: "
              f"{ {dt: len(e) for dt, e in errs.items()} }", flush=True)
        return {dt: {"harness_launches": launches[dt], "harness_max_abs_err": max(errs[dt])}
                for dt in kernels}
    finally:
        for p in procs.values():  # a failed or timed-out child leaves the others running
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(HARNESS_DIR, ignore_errors=True)


FETCH_DIR = os.path.join(ROOT, "build", "chip_smoke_fetch")
FETCH_DATASET = "mini_beir"
PROXY_VARS = ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY", "HTTPS_PROXY", "ALL_PROXY")
# The online fetch in a process of its own, with BEIR_BASE and DATASET_MD5
# pointed at the loopback server: argv <base url> <dataset> <md5> <flags...>.
FETCH_ONLINE = ("import sys; sys.path.insert(0, 'scripts'); import fetch_torch_eval_assets as f; "
                "f.BEIR_BASE = sys.argv[1]; f.DATASET_MD5 = {sys.argv[2]: sys.argv[3]}; "
                "sys.exit(f.main(sys.argv[4:]))")


def loopback_env():
    """This process's environment with no proxy: urllib would send even a
    request to 127.0.0.1 through one."""
    env = {k: v for k, v in os.environ.items() if k not in PROXY_VARS}
    env["no_proxy"] = env["NO_PROXY"] = "127.0.0.1,localhost"
    return env


@contextlib.contextmanager
def loopback_zip(dataset_dir, name, work):
    """`<name>.zip` of `dataset_dir` (laid out as BEIR's zips lay a dataset
    out: <name>/corpus.jsonl, ...) served by an `http.server` thread on
    127.0.0.1. Yields (base url, the zip's md5, the paths requested)."""
    import hashlib
    import http.server
    import threading
    import zipfile

    os.makedirs(work, exist_ok=True)
    zip_path = os.path.join(work, f"{name}.zip")
    with zipfile.ZipFile(zip_path, "w") as z:
        for dirpath, _, files in sorted(os.walk(dataset_dir)):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                z.write(full, os.path.join(name, os.path.relpath(full, dataset_dir)))
    requested = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=work, **kw)

        def do_GET(self):
            requested.append(self.path)
            super().do_GET()

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with open(zip_path, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        yield f"http://127.0.0.1:{server.server_address[1]}", md5, requested
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def fetch_phase(device, mk, smi):
    """The online half of the eval-asset fetch over loopback: a zip of the
    mini BEIR fixture served on 127.0.0.1, scripts/fetch_torch_eval_assets.py
    run online twice (--device cuda, the fixture checkpoint as --model, a
    fresh --assets-dir; BEIR_BASE and DATASET_MD5 set in the script's
    process): the zip arrives once with its md5 checked, the second run
    requests nothing, a wrong md5 raises and leaves no file, each run's
    provenance names the loopback URL and md5 and its NDCG@10 and recall@10
    pass the offline dry run's gates. The bf16 kernel is held against its
    plain version on the mini BEIR grid, rebuilt here as the script's server
    builds it. Returns the bf16 kernel's launches in the two runs (their
    children's counts) and its largest difference from the plain version."""
    import hashlib
    from pathlib import Path

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import eval_torch_beir
    import fetch_torch_eval_assets as fetch

    from nextplaid_tpu_torch.encoder import Colbert
    from nextplaid_tpu_torch.eval import load_beir
    from nextplaid_tpu_torch.index import DeviceIndex, IndexConfig, create_index

    t_phase = time.perf_counter()
    shutil.rmtree(FETCH_DIR, ignore_errors=True)
    assets = os.path.join(FETCH_DIR, "assets")
    try:
        ckpt = fetch.write_fixture_checkpoint(Path(FETCH_DIR) / "mini-colbert")
        with loopback_zip(str(fetch.FIXTURE_DIR), FETCH_DATASET,
                          os.path.join(FETCH_DIR, "served")) as (base, md5, requested):
            argv = ["--dataset", FETCH_DATASET, "--model", str(ckpt), "--assets-dir", assets,
                    "--device", "cuda"]
            runs = []
            for k in range(2):
                t0 = time.perf_counter()
                proc = subprocess.Popen([sys.executable, "-c", FETCH_ONLINE, base, FETCH_DATASET,
                                         md5, *argv], cwd=ROOT, env=loopback_env(),
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                lines, wall = finish_script(proc, f"fetch_torch_eval_assets.py online, run {k + 1}",
                                            t0)
                runs.append((lines[-1], wall, list(requested)))
            url = f"{base}/{FETCH_DATASET}.zip"
            if [r[2] for r in runs] != [[f"/{FETCH_DATASET}.zip"]] * 2:
                raise AssertionError(f"fetch: requests after each run {[r[2] for r in runs]}")
            with open(os.path.join(assets, f"{FETCH_DATASET}.zip"), "rb") as f:
                if hashlib.md5(f.read()).hexdigest() != md5:
                    raise AssertionError("fetch: the zip on disk is not the one served")
            wrong = Path(FETCH_DIR) / "wrong"
            wrong.mkdir()
            proxies = {k: os.environ.pop(k) for k in PROXY_VARS if k in os.environ}
            try:
                fetch._download(url, wrong / f"{FETCH_DATASET}.zip", "0" * 32)
            except RuntimeError as e:
                refused = str(e)
            else:
                raise AssertionError("fetch: a wrong md5 was accepted")
            finally:
                os.environ.update(proxies)
            if list(wrong.iterdir()):
                raise AssertionError(f"fetch: a refused download left {list(wrong.iterdir())}")
        launches = 0
        for rec, wall, _ in runs:
            m = rec["metrics"]
            if m["ndcg@10"] < fetch.MIN_NDCG10 or m["recall@10"] < fetch.MIN_RECALL10:
                raise AssertionError(f"fetch: {m} below the gates")
            if rec["provenance"] != {"dataset_url": url, "dataset_md5": md5,
                                     "model": str(ckpt), "model_revision": None}:
                raise AssertionError(f"fetch: provenance {rec['provenance']}")
            if rec["device"] != "cuda" or rec["kernel_launches"]["bf16"] < 1:
                raise AssertionError(f"fetch: device {rec['device']}, launches "
                                     f"{rec['kernel_launches']}")
            launches += rec["kernel_launches"]["bf16"]
        # The run's grid, rebuilt here: its checkpoint and corpus, nbits 4.
        docs, queries, _ = load_beir(str(fetch.FIXTURE_DIR), split="test")
        enc = Colbert(str(ckpt), device=device)
        idx = os.path.join(FETCH_DIR, "grid")
        create_index(enc.encode_documents([eval_torch_beir.doc_text(d) for d in docs]), idx,
                     IndexConfig(nbits=4), device=device)
        grid = DeviceIndex.load(idx, device=device).with_token_grid()
        err = check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference,
                           exact_grid_args(grid, enc.encode_queries(list(queries.values()))),
                           f"fetch mini BEIR grid {tuple(grid.token_grid.shape)}, "
                           f"{len(queries)}q")
        take_launches(mk.maxsim_grid_scores)  # the comparison's launch: not the path's
        del enc, grid
        parts = [f"run {k + 1} ndcg@10 {r[0]['metrics']['ndcg@10']:.4f} recall@10 "
                 f"{r[0]['metrics']['recall@10']:.4f}, {r[1]:.1f} s, {len(r[2])} request(s) so far"
                 for k, r in enumerate(runs)]
        print(f"fetch [{smi}]: fetch_torch_eval_assets.py online over loopback ({url}, md5 "
              f"{md5}): {'; '.join(parts)}; the zip arrived once, md5 checked, the second run "
              f"requested nothing; a wrong md5 raised ({refused[:60]}...) and left no file; "
              f"provenance = the loopback URL and md5; kernel launches bf16 {launches}; the phase "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        return {"fetch_launches": launches, "fetch_max_abs_err": err}
    finally:
        shutil.rmtree(FETCH_DIR, ignore_errors=True)


DEPLOY_DIR = os.path.join(ROOT, "build", "chip_smoke_deploy")
DEPLOY_MODEL = "gte-moderncolbert-random"  # a directory under the models volume
DEPLOY_START_S = 300
DEPLOY_TEXT_QUERIES = ("protein folding in yeast", "vaccine cohort study",
                       "climate model retrieval", "neuron genome")
# At exit, writes the process's MaxSim launch counts, its peak allocated
# device memory, its argv and whether it is a bench_torch.py measurement child
# to $CHIP_SMOKE_COUNTS ("{pid}" in the path becomes the process id): neither
# a server nor the bench reports its launches. Prefixed to LAUNCH_HOOK, and
# the bench phase's sitecustomize.py, which every process of the bench loads.
COUNTS_AT_EXIT = """\
import atexit, json, os, sys
def _counts():
    mk = sys.modules.get("nextplaid_tpu_torch.ops.maxsim_kernel")
    torch = sys.modules.get("torch")
    out = {"bf16": mk.maxsim_grid_scores.launches if mk else 0,
           "int8": mk.maxsim_grid_scores_int8i.launches if mk else 0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9
           if torch is not None and torch.cuda.is_initialized() else 0.0,
           "argv": sys.argv, "bench_child": os.environ.get("_BENCH_CHILD") == "1"}
    with open(os.environ["CHIP_SMOKE_COUNTS"].replace("{pid}", str(os.getpid())), "w") as f:
        json.dump(out, f)
atexit.register(_counts)
"""
# Runs a replayed `python -m <module> ...` argv as -m does (runpy), with
# COUNTS_AT_EXIT.
LAUNCH_HOOK = COUNTS_AT_EXIT + """\
import runpy
sys.argv = sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def mapped_libraries(pid):
    """The shared objects process `pid` has mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return {ln.split()[-1] for ln in f if ln.rstrip().endswith(".so")}


def deploy_phase(device, mk, smi, topics, queries):
    """The CUDA image replayed on the card, without docker: a directory
    holding only docker/Dockerfile.cuda's COPY set stands for /app; its
    build step and import check run there as the image runs them; then the
    server starts twice from the image's ENTRYPOINT and docker-compose.yml's
    command and environment (docker-compose.cuda.yml laid over it, the
    volumes mapped to the SciFact index of the earlier phases and a model
    directory at GTE-ModernColBERT-v1's widths): (a) with the compose
    defaults (serve mode and pin dtype "auto": the bf16 kernel), (b) with
    NEXT_PLAID_SERVE_MODE=grid_only (the int8 kernel). Each is driven
    through the SDK: /health, the 320 queries as 64-query requests, text
    queries, one 32-doc /documents batch and a search for it. HTTP top-10 =
    in-process search on the same index; the build directory gains no file
    after the build step; the kernels and the native host library the
    servers load are the copy's. Each kernel is held against its plain
    version at the servers' arguments. Returns each kernel's launches in
    the servers and its largest difference from the plain version."""
    import signal
    from pathlib import Path

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_deploy_spec as spec

    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.api import state as port_state
    from nextplaid_tpu_torch.api.models import IndexConfigStored
    from nextplaid_tpu_torch.client import NextPlaidClient
    from nextplaid_tpu_torch.client.client import _doc_payload
    from nextplaid_tpu_torch.encoder import BackboneConfig, ColbertConfig, init_random_params
    from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters, load_grid_only, search_batch
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.storage import native
    from nextplaid_tpu_torch.storage.npy import atomic_write_json, load_json

    t_phase = time.perf_counter()
    shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
    app = Path(DEPLOY_DIR) / "app"
    data, models = Path(DEPLOY_DIR) / "indices", Path(DEPLOY_DIR) / "models"
    kernels = {"bf16": mk.maxsim_grid_scores, "int8": mk.maxsim_grid_scores_int8i}
    plains = {"bf16": mk.maxsim_grid_scores_reference,
              "int8": mk.maxsim_grid_scores_int8i_reference}
    proc = None
    try:
        image = spec.read_image()
        copied = spec.copy_image_files(app, image=image)
        if (app / "nextplaid_tpu").exists() or any(c.startswith("nextplaid_tpu/") for c in copied):
            raise AssertionError("deploy: the JAX package is in the image's COPY set")
        host_env = loopback_env()
        steps = {}
        for name, argv in (("build step", image.build_step), ("import check", image.import_check)):
            r = spec.replay(image, argv, app, host_env, sys.executable)
            t0 = time.perf_counter()
            out = subprocess.run(r.argv, cwd=r.cwd, env=r.env, capture_output=True, text=True,
                                 timeout=900)
            steps[name] = time.perf_counter() - t0
            if out.returncode != 0:
                raise AssertionError(f"deploy: the image's {name} exited {out.returncode}: "
                                     f"{out.stderr[-3000:]}")
        build_dir = app / "build" / "nextplaid_tpu_torch"
        built = {p.name: p.stat().st_mtime_ns for p in build_dir.iterdir()}
        want_libs = {f"{src.stem}-{mk.build_tag(src)}.so" for src in mk.SERVED_SOURCES}
        want_libs.add(native.library_path().name)
        if not want_libs <= set(built):
            raise AssertionError(f"deploy: the build step left {sorted(built)}, not {want_libs}")
        for log in build_dir.glob("*.log"):
            if "serialized" in log.read_text():
                raise AssertionError(f"deploy: ptxas serialized wgmma in {log.name}")
        print(f"deploy build [{smi}]: {len(copied)} files of the COPY set "
              f"{image.copy_set}; build step {steps['build step']:.2f} s (nvcc x3 at once, g++), "
              f"import check {steps['import check']:.2f} s; {app.name}/build/nextplaid_tpu_torch: "
              f"{', '.join(sorted(built))}", flush=True)

        # The volumes: the SciFact index as a deployment holds it (the
        # server's config.json, metadata on every doc, no merge cache) and
        # a model directory.
        path = data / "scifact"
        shutil.copytree(SERVICE_SRC, path, ignore=shutil.ignore_patterns("merged"))
        n0 = load_json(path / "metadata.json")["num_documents"]
        filtering.create(str(path), doc_metadata(range(n0)), list(range(n0)))
        atomic_write_json(str(path / "config.json"), IndexConfigStored().model_dump())
        tok, vocab = char_wordpiece()
        bcfg = BackboneConfig(**GTE_WIDTHS)
        ccfg = ColbertConfig(query_prefix="[Q]", document_prefix="[D]", query_length=32,
                             document_length=300, embedding_dim=GTE_WIDTHS["projection_dim"],
                             mask_token_id=vocab["[MASK]"], pad_token_id=vocab["[PAD]"],
                             uses_token_type_ids=False)
        write_model_dir(str(models / DEPLOY_MODEL), init_random_params(bcfg, seed=0), GTE_WIDTHS,
                        tok, ccfg)
        user = {"NEXT_PLAID_DATA": str(data), "NEXT_PLAID_MODELS": str(models),
                "MODEL": f"/models/{DEPLOY_MODEL}"}

        params = SearchParameters(top_k=10)
        nq, q64 = len(queries), queries[:SVC_REQUEST_QUERIES]
        q_arr, _ = _pad_queries(q64, 128)
        qflat = torch.from_numpy(q_arr.reshape(-1, 128)).to(device)
        out = {dt: {"deploy_launches": 0, "deploy_max_abs_err": 0.0} for dt in kernels}
        for label, extra, dtype in (("a", {}, "bf16"),
                                    ("b", {"NEXT_PLAID_SERVE_MODE": "grid_only"}, "int8")):
            n_now = load_json(path / "metadata.json")["num_documents"]
            # The in-process reference, loaded as the server loads this mode
            # (the merge cache off: the server's own load must merge).
            with merge_cache_flag("0"):
                if dtype == "bf16":
                    ref = DeviceIndex.load(str(path), capacity_factor=port_state.SERVE_CAPACITY_FACTOR,
                                           grid_aware_capacity=True, device=device).with_token_grid()
                    if ref.token_grid is None or ref.grid_is_int8:
                        raise AssertionError("deploy (a): the served load did not pin a bf16 grid")
                    args = [exact_grid_args(ref, q64)]
                else:
                    ref = load_grid_only(str(path), dtype="int8", device=device)
                    qi8, qs = quantize_queries_int8(qflat)
                    args = [(qi8, qs, g, sc, q_arr.shape[1]) for g, sc in zip(
                        ref.grid_buckets or (ref.token_grid,), ref.scale_buckets or (ref.token_scales,))]
            want, pass_s = warm_passes(lambda: search_batch(ref, queries, params), SVC_PASSES)
            inproc = qps_line(nq, pass_s)
            out[dtype]["deploy_max_abs_err"] = max(
                check_kernel(kernels[dtype], plains[dtype], a,
                             f"deploy ({label}) {dtype}, {SVC_REQUEST_QUERIES}q x {tuple(a[-3].shape)}")
                for a in args)
            take_launches(kernels[dtype])  # the parent's: not the servers'
            grid_shape = tuple(args[0][-3].shape) if len(args) == 1 else [tuple(a[-3].shape) for a in args]
            del ref, args
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(path / "merged", ignore_errors=True)

            service = spec.compose_service({**user, **extra})
            port = free_port()
            r = spec.replay(image, spec.server_argv(image, service), app, host_env,
                            sys.executable, service=service, port=port)
            pythonpath = r.env["PYTHONPATH"].split(os.pathsep)
            if pythonpath != [str(app)] or any((Path(d) / "nextplaid_tpu").exists()
                                               for d in pythonpath + [r.cwd]):
                raise AssertionError(f"deploy ({label}): PYTHONPATH {pythonpath} reaches the JAX package")
            counts = Path(DEPLOY_DIR) / f"counts_{label}.json"
            log = open(Path(DEPLOY_DIR) / f"server_{label}.log", "w")
            t0 = time.perf_counter()
            proc = subprocess.Popen([r.argv[0], "-c", LAUNCH_HOOK, *r.argv[1:]], cwd=r.cwd,
                                    env=dict(r.env, CHIP_SMOKE_COUNTS=str(counts)), stdout=log,
                                    stderr=subprocess.STDOUT)
            log.close()
            url = f"http://127.0.0.1:{port}"
            client = NextPlaidClient(url, timeout=600)
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"deploy ({label}): the server exited {proc.returncode}: "
                                         f"{(Path(DEPLOY_DIR) / f'server_{label}.log').read_text()[-3000:]}")
                try:
                    health = client.health()
                    break
                except Exception:  # noqa: BLE001 - not listening yet
                    if time.perf_counter() - t0 > DEPLOY_START_S:
                        raise
                    time.sleep(0.25)
            start_s = time.perf_counter() - t0
            if health["status"] != "ok" or health["model"]["embedding_dim"] != 128 or [
                    i["name"] for i in health["indices"]] != ["scifact"]:
                raise AssertionError(f"deploy ({label}): /health {health}")
            t0 = time.perf_counter()
            client.search("scifact", q64, top_k=10)  # loads (and pins) the index
            first_s = time.perf_counter() - t0

            chunks = [queries[s : s + SVC_REQUEST_QUERIES] for s in range(0, nq, SVC_REQUEST_QUERIES)]
            jobs = [lambda c, q=q: c.search("scifact", q, top_k=10)
                    for _ in range(SVC_PASSES * SVC_CLIENTS) for q in chunks]
            bodies, wall, _ = run_clients(SVC_CLIENTS, jobs, url)
            got = [res for body in bodies for res in http_results(body)]
            for p in range(0, len(got), nq):
                assert_same_topk(got[p : p + nq], want, SVC_RTOL, f"deploy ({label}) vs in-process")
            texts = [http_results(client.search("scifact", [t], top_k=10))[0]
                     for t in DEPLOY_TEXT_QUERIES]
            if any(len(t.passage_ids) != 10 for t in texts):
                raise AssertionError(f"deploy ({label}): a text query returned {texts}")

            docs = new_docs(topics, MUT_BATCH, seed=700 + ord(label))
            ids = list(range(n_now, n_now + MUT_BATCH))
            t0 = time.perf_counter()
            resp = client._request("POST", "/indices/scifact/documents", json={
                "documents": [_doc_payload(d) for d in docs], "metadata": doc_metadata(ids)})
            post_ms = 1e3 * (time.perf_counter() - t0)
            if (resp["start_id"], resp["total_documents"]) != (n_now, n_now + MUT_BATCH):
                raise AssertionError(f"deploy ({label}): /documents answered {resp}")
            top = [res.passage_ids[0] for res in http_results(
                client.search("scifact", [d[:32] for d in docs], top_k=10))]
            searchable_ms = 1e3 * (time.perf_counter() - t0)
            if top != ids:
                raise AssertionError(f"deploy ({label}): the posted docs are not their own "
                                     f"queries' top hits: {top} vs {ids}")

            libs = mapped_libraries(proc.pid)
            ours = {Path(x).name for x in libs if Path(x).parent == build_dir}
            foreign = [x for x in libs if ("maxsim_" in x or "union_grid" in x
                                           or "approx_codes" in x or "nextplaid_host" in x)
                       and Path(x).parent != build_dir]
            need = {f"{src.stem}-{mk.build_tag(src)}.so" for src in mk.SERVED_SOURCES}
            if dtype == "bf16":  # the full load merges the chunks natively
                need.add(native.library_path().name)
            if foreign or not need <= ours:
                raise AssertionError(f"deploy ({label}): the server mapped {sorted(ours)} from the "
                                     f"copy and {foreign} from elsewhere; needs {sorted(need)}")
            after = {p.name: p.stat().st_mtime_ns for p in build_dir.iterdir()}
            if after != built:
                raise AssertionError(f"deploy ({label}): the build directory changed: "
                                     f"{sorted(set(after) ^ set(built))}")

            t0 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            stop_s = time.perf_counter() - t0
            proc = None
            if rc != 0:
                raise AssertionError(f"deploy ({label}): the server exited {rc} on SIGTERM")
            n = json.loads(counts.read_text())
            if n[dtype] < 1:
                raise AssertionError(f"deploy ({label}): the server launched {n}")
            for dt in kernels:
                out[dt]["deploy_launches"] += n[dt]
            print(f"deploy ({label}) [{smi}; NEXT_PLAID_SERVE_MODE="
                  f"{r.env['NEXT_PLAID_SERVE_MODE']}, NEXT_PLAID_PIN_DTYPE="
                  f"{r.env['NEXT_PLAID_PIN_DTYPE']}; {dtype} grid {grid_shape}]: "
                  f"{' '.join(r.argv[1:4])} ... {' '.join(r.argv[-8:])}; /health after "
                  f"{start_s:.1f} s, first search (load + pin) {first_s:.2f} s; {len(got)} queries "
                  f"in {len(jobs)} requests of {SVC_REQUEST_QUERIES} from {SVC_CLIENTS} clients, "
                  f"{len(got) / wall:.1f} QPS over HTTP (in process {inproc}), top-10 = in-process; "
                  f"{len(DEPLOY_TEXT_QUERIES)} text queries answered; a {MUT_BATCH}-doc /documents "
                  f"POST {post_ms:.1f} ms, searchable {searchable_ms:.1f} ms after it began; "
                  f"mapped from the copy: {', '.join(sorted(ours))}; the build directory gained "
                  f"nothing; exit 0 {stop_s:.2f} s after SIGTERM; launches bf16 {n['bf16']}, int8 "
                  f"{n['int8']}; the server's peak allocated {n['peak_gb']:.3f} GB", flush=True)
        print(f"deploy: the phase {time.perf_counter() - t_phase:.1f} s", flush=True)
        return out
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(DEPLOY_DIR, ignore_errors=True)
        shutil.rmtree(SERVICE_SRC, ignore_errors=True)  # the last phase that reads it


BENCH_DIR = os.path.join(ROOT, "build", "chip_smoke_bench")
BENCH_TIMEOUT_S = 600  # one step: the probe and three children, or the composite
BENCH_EMBEDDINGS = 1_441_163  # the SciFact-shape corpus's tokens (PERF.md section 4)
BENCH_MIN_LAUNCHES = 1 + 2 * 12  # the warm-up, then 12 passes at each of two windows
BENCH_E2E_DOCS, BENCH_E2E_QUERIES = 5183, 300  # the composite's defaults
E2E_MIN_OVERLAP = 0.8  # the composite's own gate (API top-10 vs the library's)
E2E_ORACLE_QUERIES = 64  # the composite's library oracle: its first 64 queries
E2E_CAPTURE_MAX_Q = 16  # a coalesced batch holds at most its 16 workers' queries
# Appended to the bench phase's sitecustomize.py; acts where CHIP_SMOKE_CAPTURE
# names a directory (step (c) only). Once the port's modules are imported it
# wraps (a) the bf16 kernel's launch: the grid of the first launch at most
# E2E_CAPTURE_MAX_Q queries wide, and each distinct query count's first
# batch on it, are kept and saved at exit as kernel_args.pt; (b)
# DeviceIndex.load and search_batch: the first search on an unpinned index
# (the composite's library oracle) copies the directory last loaded to
# index/ and its query embeddings to oracle_queries.npy.
CAPTURE_E2E = """\
import importlib.abc, importlib.machinery
_CAP = os.environ.get("CHIP_SMOKE_CAPTURE")
_cap = {"grid": None, "queries": {}, "loaded": None, "oracle": False}
def _on_kernel(mk):
    launch = mk._launch
    def _launch(queries_flat, grid, doclens, tq):
        q_n = queries_flat.shape[0] // tq
        key = (grid.data_ptr(), tuple(grid.shape))
        if _cap["grid"] is None and q_n <= %(max_q)d:
            _cap["grid"] = (key, grid.clone(), doclens.clone(), tq)
        if _cap["grid"] is not None and _cap["grid"][0] == key and q_n not in _cap["queries"]:
            _cap["queries"][q_n] = queries_flat.clone()
        return launch(queries_flat, grid, doclens, tq)
    mk._launch = _launch
def _on_container(m):
    load = m.DeviceIndex.load.__func__
    def _load(cls, path, *args, **kwargs):
        _cap["loaded"] = path
        return load(cls, path, *args, **kwargs)
    m.DeviceIndex.load = classmethod(_load)
def _on_search(m):
    search = m.search_batch
    def search_batch(index, queries, *args, **kwargs):
        if index.token_grid is None and not _cap["oracle"]:
            import shutil, numpy
            _cap["oracle"] = True
            shutil.copytree(_cap["loaded"], os.path.join(_CAP, "index"))
            numpy.save(os.path.join(_CAP, "oracle_queries.npy"), numpy.stack(queries))
        return search(index, queries, *args, **kwargs)
    m.search_batch = search_batch
class _AfterImport(importlib.abc.MetaPathFinder):
    hooks = {"nextplaid_tpu_torch.ops.maxsim_kernel": _on_kernel,
             "nextplaid_tpu_torch.index.container": _on_container,
             "nextplaid_tpu_torch.index.search": _on_search}
    def find_spec(self, name, path=None, target=None):
        hook = self.hooks.get(name)
        spec = hook and importlib.machinery.PathFinder.find_spec(name, path)
        if not spec:
            return None
        run = spec.loader.exec_module
        def exec_module(module):
            run(module)
            hook(module)
        spec.loader.exec_module = exec_module
        return spec
def _save():
    if _cap["grid"] is not None:
        import torch
        _, grid, doclens, tq = _cap["grid"]
        torch.save({"grid": grid.cpu(), "doclens": doclens.cpu(), "tq": tq,
                    "queries": {n: q.cpu() for n, q in _cap["queries"].items()}},
                   os.path.join(_CAP, "kernel_args.pt"))
if _CAP:
    sys.meta_path.insert(0, _AfterImport())
    atexit.register(_save)
""" % {"max_q": E2E_CAPTURE_MAX_Q}


def composite_kernel_checks(device, mk, capture):
    """The bf16 kernel against its plain version at what the composite's
    server gave it (CAPTURE_E2E's kernel_args.pt): its served grid and one
    coalesced query batch of each width it launched. Returns (the largest
    |difference|, the widths, the grid)."""
    saved = torch.load(os.path.join(capture, "kernel_args.pt"))
    if not saved["queries"]:
        raise AssertionError("bench (e2e): the composite's server launched no bf16 kernel "
                             "on its served grid")
    grid, doclens = saved["grid"].to(device), saved["doclens"].to(device)
    widths = sorted(saved["queries"])
    err = max(check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference,
                           (saved["queries"][n].to(device), grid, doclens, saved["tq"]),
                           f"bench (e2e): the server's grid {tuple(grid.shape)}, {n} "
                           f"coalesced queries")
              for n in widths)
    return err, widths, grid


def _top10_overlap(a, b):
    return float(np.mean([len(set(x.passage_ids[:10]) & set(y.passage_ids[:10])) / 10
                          for x, y in zip(a, b)]))


def composite_overlap_causes(device, capture, reported, served_grid):
    """Takes the composite's API-vs-library top-10 overlap apart on its own
    index and oracle embeddings (CAPTURE_E2E's copies): the library's
    default search (the unpinned index) against the server's path (the
    pinned bf16 grid and its kernel) on the same embeddings; the server's
    path on each query encoded alone (the server encodes coalesced batches
    of 1-16) against the oracle's batch of 64; each against the f32
    exhaustive search; how far below the f32 tenth score each doc lies
    that the server's top-10 holds and the f32 one does not, beside the
    largest |server score - f32 score| of a doc both hold; and whether the
    live rows of `served_grid`, the grid the server launched the kernel
    on, equal a fresh pin of the same index. Returns the readings."""
    import importlib.util

    from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters, search_batch

    spec = importlib.util.spec_from_file_location(
        "profile_torch_e2e_composite", os.path.join(ROOT, "scripts", "profile_torch_e2e_composite.py"))
    composite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(composite)
    oracle_q = list(np.load(os.path.join(capture, "oracle_queries.npy")))
    index = DeviceIndex.load(os.path.join(capture, "index"), device=device)
    params = SearchParameters(top_k=10)
    library = search_batch(index, oracle_q, params)
    exact = search_batch(index, oracle_q, SearchParameters(top_k=20, mode="exact",
                                                           stage1_precision="highest"))
    served = index.with_token_grid()
    served_64 = search_batch(served, oracle_q, params)
    encoder, vocab = composite.make_encoder(device)
    docs = composite.make_text_corpus(vocab, n_docs=BENCH_E2E_DOCS)
    texts, _ = composite.make_excerpt_queries(docs, n_queries=BENCH_E2E_QUERIES)
    texts = texts[:len(oracle_q)]
    again = encoder.encode_queries(texts)
    alone = [encoder.encode_queries([t])[0] for t in texts]
    served_1 = search_batch(served, alone, params)
    gaps, score_err, beyond_20 = [], 0.0, 0
    for got, want in zip(served_64, exact):
        f32 = dict(zip(want.passage_ids, want.scores))
        top10 = set(want.passage_ids[:10])
        for doc, score in zip(got.passage_ids, got.scores):
            if doc in top10:
                score_err = max(score_err, abs(score - f32[doc]))
            elif doc in f32:
                gaps.append(want.scores[9] - f32[doc])
            else:
                beyond_20 += 1
    nd = index.num_documents
    td = min(served_grid.shape[1], served.token_grid.shape[1])
    out = {
        "reported": reported,
        "library_vs_served_same_embeddings": _top10_overlap(library, served_64),
        "served_alone_vs_served_batch64": _top10_overlap(served_1, served_64),
        "library_vs_served_alone": _top10_overlap(library, served_1),
        "library_vs_exact_f32": _top10_overlap(library, exact),
        "served_vs_exact_f32": _top10_overlap(served_64, exact),
        "max_abs_emb_batch64_rerun": max(float(np.abs(a - b).max())
                                         for a, b in zip(again, oracle_q)),
        "max_abs_emb_alone_vs_batch64": max(float(np.abs(a - b).max())
                                            for a, b in zip(alone, oracle_q)),
        "library_route": "exact" if index.num_embeddings <= params.exact_max_embeddings
        else "staged",
        "swaps": len(gaps) + beyond_20,
        "swaps_beyond_f32_top20": beyond_20,
        "largest_f32_gap_a_swap_crosses": max(gaps, default=0.0),
        "largest_served_vs_f32_score_diff": score_err,
        "f32_tenth_scores": [min(w.scores[9] for w in exact), max(w.scores[9] for w in exact)],
        "served_grid_live_rows_equal_fresh_pin": bool(torch.equal(
            served_grid[:nd, :td], served.token_grid[:nd, :td])),
    }
    del index, served, encoder
    return out


def run_bench(label, env, counts_dir):
    """`python bench_torch.py` from the root of this checkout under `env`,
    in a session of its own (a timeout kills its children too); fails on a
    non-zero exit or a last line that does not parse. Returns (the last
    line, the counts each of its processes wrote at exit, in exit order,
    the wall seconds)."""
    import signal

    os.makedirs(counts_dir)
    env = dict(env, CHIP_SMOKE_COUNTS=os.path.join(counts_dir, "{pid}.json"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"bench ({label}) outlived {BENCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench ({label}) exited {proc.returncode}: {out[-2000:]}\n{err[-3000:]}")
    try:
        line = json.loads(out.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        raise AssertionError(f"bench ({label}): the last line does not parse: {out[-2000:]}")
    procs = []
    for name in sorted(os.listdir(counts_dir), key=lambda n: os.path.getmtime(
            os.path.join(counts_dir, n))):
        with open(os.path.join(counts_dir, name)) as f:
            procs.append(json.load(f))
    return line, procs, wall


def bench_phase(device, mk, smi, scifact_qps):
    """bench_torch.py as a user runs it, each step a process of its own from
    the root of this checkout: (a) at SciFact scale with a fresh BENCH_IDX
    (child 1 builds it, children 2-3 reload it), (b) BENCH_PIN_DTYPE=int8
    over the same index, (c) BENCH_E2E=1 at the composite's defaults (5,183
    texts, 300 queries). A sitecustomize.py at the front of PYTHONPATH has
    every process of the steps write COUNTS_AT_EXIT. Fails unless each step
    exits 0 with 3 runs and none failed, 1,441,163 tokens, a pinned grid and
    recall@10 >= MIN_RECALL (bf16) or MIN_RECALL_INT8 (int8), each
    measurement child launched its pin's kernel at least BENCH_MIN_LAUNCHES
    times, (c) passed its overlap gate with its server's launches of the
    bf16 kernel, and the bf16 kernel agrees with its plain version at the
    arguments (c)'s server gave it (CAPTURE_E2E). Then (c)'s overlap is
    taken apart on its own index and oracle embeddings (printed, not
    gated). `scifact_qps` is the sequential passes' p50 of phases 5-6,
    printed beside the pipelined ones. Returns (each kernel's launches in
    the phase, the bf16 kernel's largest |difference| on (c)'s grid)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the bench's processes get the card
    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    os.makedirs(BENCH_DIR)
    try:
        with open(os.path.join(BENCH_DIR, "sitecustomize.py"), "w") as f:
            f.write(COUNTS_AT_EXIT + CAPTURE_E2E)
        pythonpath = [BENCH_DIR] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
        base = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "_BENCH_", "E2E_"))}
        base.update(PYTHONPATH=os.pathsep.join(pythonpath),
                    BENCH_IDX=os.path.join(BENCH_DIR, "scifact_scale"))
        launches = {"bf16": 0, "int8": 0}
        for label, floor in (("bf16", MIN_RECALL), ("int8", MIN_RECALL_INT8)):
            line, procs, wall = run_bench(label, dict(base, BENCH_PIN_DTYPE=label),
                                          os.path.join(BENCH_DIR, f"counts_{label}"))
            print(f"bench ({label}) [{smi}]: {json.dumps(line)}", flush=True)
            d = line.get("detail", {})
            got = (line.get("metric"), d.get("runs"), d.get("runs_failed"), d.get("num_embeddings"),
                   d.get("pinned_token_grid"), d.get("pin_dtype"))
            want = ("scifact_scale_search_qps", 3, 0, BENCH_EMBEDDINGS, True, label)
            if got != want or not d["recall_at_10_vs_f32_oracle"] >= floor:
                raise AssertionError(f"bench ({label}): (metric, runs, runs_failed, tokens, pinned, "
                                     f"pin) {got}, want {want}; recall@10 "
                                     f"{d.get('recall_at_10_vs_f32_oracle')} (floor {floor})")
            children = [p for p in procs if p["bench_child"]]
            if len(children) != 3 or any(p[label] < BENCH_MIN_LAUNCHES for p in children):
                raise AssertionError(f"bench ({label}): its measurement children launched the "
                                     f"{label} kernel {[p[label] for p in children]} times (at "
                                     f"least {BENCH_MIN_LAUNCHES} each, 3 children)")
            for p in procs:
                for k in launches:
                    launches[k] += p[k]
            print(f"bench ({label}) [{smi}]: p50 {line['value']} QPS (median of the runs' "
                  f"{d['qps_p50_per_run']}, spread {d['cross_run_spread_pct']}%); per window "
                  f"per run {d['qps_p50_per_window_per_run']}, best {d['pipeline_windows']}; "
                  f"beside {scifact_qps[label]:.1f} QPS, the p50 of phase 5-6's sequential "
                  f"search_batch passes in this run; mfu_pct {d['mfu_pct']}; index_build_s "
                  f"{d['index_build_s']} ({d['indexing_docs_per_s']} docs/s); recall@10 "
                  f"{d['recall_at_10_vs_f32_oracle']}; device probes {d['device_probes_per_run']}; "
                  f"children's peak allocated {[round(p['peak_gb'], 3) for p in children]} GB, "
                  f"{label} launches {[p[label] for p in children]}; the step {wall:.1f} s",
                  flush=True)

        capture = os.path.join(BENCH_DIR, "capture_e2e")
        os.makedirs(capture)
        line, procs, wall = run_bench("e2e", dict(base, BENCH_E2E="1", CHIP_SMOKE_CAPTURE=capture),
                                      os.path.join(BENCH_DIR, "counts_e2e"))
        print(f"bench (e2e) [{smi}]: {json.dumps(line)}", flush=True)
        d = line.get("detail", {})
        got = (line.get("metric"), d.get("n_docs"), d.get("n_queries"))
        want = ("e2e_composite", BENCH_E2E_DOCS, BENCH_E2E_QUERIES)
        if got != want or not d["api_vs_library_top10_overlap"] >= E2E_MIN_OVERLAP:
            raise AssertionError(f"bench (e2e): (metric, docs, queries) {got}, want {want}; "
                                 f"overlap {d.get('api_vs_library_top10_overlap')}")
        server = [p for p in procs if any("profile_torch_e2e_composite" in a for a in p["argv"])]
        if len(server) != 1 or server[0]["bf16"] < 1:
            raise AssertionError(f"bench (e2e): the composite's processes launched {procs}")
        for p in procs:
            for k in launches:
                launches[k] += p[k]
        print(f"bench (e2e) [{smi}]: {d['search_qps']} QPS with encoding, p50 "
              f"{d['search_p50_ms']} ms, p95 {d['search_p95_ms']} ms; indexing "
              f"{d['indexing_docs_per_s']} docs/s ({d['indexing_wall_s']} s); overlap "
              f"{d['api_vs_library_top10_overlap']}; the server's process: launches bf16 "
              f"{server[0]['bf16']}, int8 {server[0]['int8']}, peak allocated "
              f"{server[0]['peak_gb']:.3f} GB; the step {wall:.1f} s", flush=True)
        err, widths, grid = composite_kernel_checks(device, mk, capture)
        print(f"bench (e2e) [{smi}]: the bf16 kernel held against its plain version on the "
              f"composite server's grid {tuple(grid.shape)} at each of its {len(widths)} "
              f"coalesced batch widths {widths}: max |diff| {err:.3e}", flush=True)
        causes = composite_overlap_causes(device, capture, d["api_vs_library_top10_overlap"],
                                          grid)
        del grid
        print(f"bench (e2e) [{smi}]: the overlap taken apart on the composite's own index "
              f"and oracle embeddings: {causes}", flush=True)
        print(f"bench: the phase {time.perf_counter() - t_phase:.1f} s; launches {launches}",
              flush=True)
        return launches, err
    finally:
        shutil.rmtree(BENCH_DIR, ignore_errors=True)


def kernel_entry(name, source, replaces, launches, max_err, ms, plain_ms, bound_ms, bound_by):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    device = torch.device("cuda")
    t_start = time.perf_counter()
    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)

    # Phase 2: build the three MaxSim libraries from the sources in this
    # checkout, one nvcc each, started together, then the union grid's and
    # stage 3b's.
    from nextplaid_tpu_torch.ops import approx_codes as ac
    from nextplaid_tpu_torch.ops import maxsim_variants as mv
    from nextplaid_tpu_torch.ops import union_grid as ug

    t0 = time.perf_counter()
    libs = mk.build_all()
    mk._library()
    mk._library_int8()
    mv._library()
    for ops in (ug, ac):
        libs[ops.SOURCE.stem] = mk.build_library(ops.SOURCE)
        ops._library()
    build_s = time.perf_counter() - t0
    for lib_path in libs.values():
        log = lib_path.with_suffix(".log").read_text().splitlines()
        ptxas = [ln.strip() for ln in log if "Used" in ln]
        print(f"build: {lib_path.name}; {'; '.join(ptxas)}", flush=True)
        serialized = [ln.strip() for ln in log if "serialized" in ln]
        if serialized:
            raise AssertionError(f"{lib_path.name}: ptxas serialized wgmma: {serialized[0]}")
    print(f"build: {len(libs)} kernel sources in {build_s:.2f} s", flush=True)
    from nextplaid_tpu_torch.storage import native

    if not native.available():
        raise AssertionError(f"the native host library did not build from {native.SOURCE}")
    print(f"build: native host library {native.library_path().name}", flush=True)

    # Phase 3: each kernel vs its plain version on the card.
    for label, args in (("bf16 edge cases", edge_case_inputs(device)),
                        ("bf16 main-path slice 64q x 512 docs", slice_inputs(device))):
        check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference, args, label)
    for label, args in (("int8 edge cases", int8_edge_inputs(device)),
                        ("int8 main-path slice 64q x 512 docs", int8_slice_inputs(device))):
        check_kernel(mk.maxsim_grid_scores_int8i, mk.maxsim_grid_scores_int8i_reference,
                     args, label)
    for case in TILING_CASES:
        check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference,
                     tiling_case_bf16(case, device), f"bf16 tiling: {case[0]}")
        check_kernel(mk.maxsim_grid_scores_int8i, mk.maxsim_grid_scores_int8i_reference,
                     tiling_case_int8(case, device), f"int8 tiling: {case[0]}")

    # Phase 4: the variant sweep (path B of the third slice).
    variants = variants_phase(device, mv, mk)
    # Phases 5-6: SciFact scale, bf16 and int8 pins; then the sixth slice's path,
    # mutations of that index.
    (bf16, _), mutation, (topics, queries), scifact_qps = scifact_phases(device, mk)
    # Phase 7: the seventh slice's path, text to a searchable index: the
    # encoder, a resumed streamed build, load, and search through the bf16
    # kernel.
    encoder, attention = encoder_phase(device, mk)
    # Phase 8: the tenth slice's path, doc-range sharding at SciFact scale on
    # an in-process mesh of four shards on the card (and in three processes).
    sharded = sharded_phase(device, mk, SERVICE_SRC, topics, queries)
    # Phase 9: the eighth slice's path, the REST service on the SciFact index with
    # the encoder, over HTTP through the SDK.
    service = service_phase(device, mk, SERVICE_SRC, topics, queries)
    # Phases 10-11: the ninth slice's paths, the RQ codebook at its own
    # operating point, then code search over this checkout.
    rq, rq_union, rq_approx = rq_phase(device, mk)
    codesearch_phase(device, mk)
    # Phases 12-14: grid-only int8 serving at scale (with the native merge and
    # the merge cache on its host load), then the third slice's main path:
    # staged search over the same corpus's full index, then that corpus as
    # sharded int8 grids (the sharded phase's (d)).
    int8, (staged, staged_union, staged_approx), mega = grid_only_phase(device, mk)
    # Phase 15: the eleventh slice's path, the entry points outside the
    # package: entry() and the dry run in this process, then the scripts.
    harness = harness_phase(device, mk, smi, topics)
    # Phases 16-17: the twelfth slice's paths: the online eval-asset fetch
    # over loopback, then the CUDA image replayed on the card, its servers
    # as processes of their own.
    fetch = fetch_phase(device, mk, smi)
    deploy = deploy_phase(device, mk, smi, topics, queries)
    # Phase 18: the thirteenth slice's path, the headline benchmark as a user
    # runs it: bench_torch.py bf16, int8 and the composite, its processes
    # counted through a sitecustomize.py.
    bench, bench_err = bench_phase(device, mk, smi, scifact_qps)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)

    # Phases 19-20: the kernels line, then the device line. The bf16 kernel's
    # launches are the SciFact path's, the staged path's, the mutation
    # phase's, the encoder phase's, the service phase's, the RQ phase's,
    # the sharded phase's (its ranks' too), the harness phase's (its
    # children's too), the fetch phase's (its children's), the deploy
    # phase's (its servers') and the bench phase's (its processes'); its ms,
    # bound and plain ms are the SciFact pass's, the staged_* keys the
    # stage-4 shape's. The int8 kernel's are the grid-only path's, the
    # mutation phase's, the service phase's, the sharded phase's, (d)
    # included, the harness phase's, the deploy phase's and the bench
    # phase's. The union grid kernel's are the staged path's and the RQ
    # phase's (RQ and flat control); its check and times are the staged
    # stage-4 shape's, the rq_* keys the RQ one's. The attention kernel's
    # are the encoder phase's, its check at the rerank cells' shapes and
    # jina-colbert-v2's request included; its check and times are that
    # check's ModernBERT global layer's, the local_* keys the local layer's,
    # the jina_* keys jina-colbert-v2's global layer's and request's. The stage-3b kernel's are the staged
    # path's and the RQ phase's flat control's ("codes" points); its check
    # and times are the flat control's at the LoTTE staged cell's operating
    # point, the staged_* keys the staged path's at "quality".
    bf16_entry = kernel_entry("maxsim_grid_scores", "nextplaid_tpu_torch/csrc/maxsim_bf16.cu",
                              "nextplaid_tpu/ops/maxsim_kernel.py:218", *bf16[1:])
    bf16_entry.update(scifact_launches=bf16_entry["launches"], **staged, **mutation["bf16"],
                      **encoder, **service["bf16"], **rq, **sharded["bf16"], **harness["bf16"],
                      **fetch, **deploy["bf16"], bench_launches=bench["bf16"],
                      bench_max_abs_err=bench_err)
    bf16_entry["launches"] += (staged["staged_launches"] + mutation["bf16"]["mutation_launches"]
                               + encoder["encoder_launches"] + service["bf16"]["service_launches"]
                               + rq["rq_launches"] + sharded["bf16"]["sharded_launches"]
                               + harness["bf16"]["harness_launches"] + fetch["fetch_launches"]
                               + deploy["bf16"]["deploy_launches"] + bench["bf16"])
    int8_entry = kernel_entry("maxsim_grid_scores_int8i", "nextplaid_tpu_torch/csrc/maxsim_int8.cu",
                              "nextplaid_tpu/ops/maxsim_kernel.py:150", *int8)
    int8_entry.update(grid_only_launches=int8_entry["launches"], **mutation["int8"],
                      **service["int8"], **sharded["int8"], **mega, **harness["int8"],
                      **deploy["int8"], bench_launches=bench["int8"])
    int8_entry["launches"] += (mutation["int8"]["mutation_launches"]
                               + service["int8"]["service_launches"]
                               + sharded["int8"]["sharded_launches"]
                               + mega["mega_sharded_launches"] + harness["int8"]["harness_launches"]
                               + deploy["int8"]["deploy_launches"] + bench["int8"])
    union_entry = kernel_entry("union_grid", "nextplaid_tpu_torch/csrc/union_grid.cu",
                               "nextplaid_tpu_torch/index/search.py:_build_union_grid_eager",
                               staged_union["staged_launches"] + rq_union["rq_launches"],
                               staged_union["max_abs_err"], staged_union["ms"],
                               staged_union["plain_ms"], staged_union["bound_ms"], "bytes")
    union_entry.update({k: v for k, v in staged_union.items()
                        if k not in ("max_abs_err", "ms", "plain_ms", "bound_ms")}, **rq_union)
    approx_entry = kernel_entry("approx_codes", "nextplaid_tpu_torch/csrc/approx_codes.cu",
                                "nextplaid_tpu_torch/index/search.py:_approx_codes_scores_eager",
                                staged_approx["launches"] + rq_approx["launches"],
                                rq_approx["max_abs_err"], rq_approx["ms"], rq_approx["plain_ms"],
                                rq_approx["bound_ms"], "bytes")
    approx_entry.update({k: v for k, v in rq_approx.items() if k not in approx_entry},
                        **{f"staged_{k}": v for k, v in staged_approx.items()})
    attention_entry = kernel_entry("varlen_attention", "nextplaid_tpu_torch/ops/attention.py",
                                   "none: nextplaid_tpu/encoder/model.py's dense XLA attention",
                                   *(attention[k] for k in ("launches", "max_abs_err", "ms",
                                                            "plain_ms", "bound_ms", "bound_by")))
    attention_entry.update({k: v for k, v in attention.items() if k not in attention_entry},
                           route="triton")
    print(json.dumps({"kernels": [bf16_entry, int8_entry, variants, union_entry,
                                  approx_entry, attention_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_worker(*sys.argv[2:7])
        sys.exit(0)
    sys.exit(main())
