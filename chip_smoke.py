"""Smoke run of nextplaid_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the three CUDA kernel sources (bf16 MaxSim, int8 MaxSim and the
MaxSim variant family, all three instances of the wgmma/TMA template of
csrc/maxsim_wgmma.cuh) from this checkout, one nvcc each, at once, fails on a
serialized-wgmma warning in the build logs, and holds each kernel against
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
     preset), stage 4 through the bf16 MaxSim kernel on the transient union
     grid: QPS, batch-1 latency, recall@10 against the same oracle, and a
     batch's time stage by stage.
  6. index mutations at SciFact scale, on the index of phase 2 (this slice's
     path): served loads with append headroom (`capacity_factor=1.5,
     grid_aware_capacity=True`) pinned bf16 and int8, ingest batches of 32
     docs through `update_or_create_with_metadata` (buffer mode) and
     `DeviceIndex.append_batch`, each checked against a fresh reload + pin;
     a capacity growth (`_grow`); a centroid expansion (mode "expand");
     FIFO eviction of the 100 oldest docs with `delete_with_options` (the
     metadata store and FTS kept in sync); and the stale-IVF reroute of a
     staged request, then `refresh_ivf` and staged recall.
Each path's kernel launch counts are set to 0 just before it and read just
after.

Prints one line per phase, then a {"kernels": [...]} JSON line, and as its
last line {"ok": true, "device": {...}}. Exits non-zero, with no result,
when CUDA is unavailable or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (dense bf16 and int8 tensor cores, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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


def make_doclens(num_docs=5183, avg_len=290, seed=0):
    """SciFact-shaped document lengths (copy of bench.py's)."""
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(avg_len, 40, num_docs), 64, 300).astype(np.int64)


def make_corpus(doclens, device, dim=128, n_topics=4096, seed=0):
    """Clustered unit-norm tokens generated on the card (noise 0.08, ~0.74
    cosine to their topic, as bench.py's corpus). Returns (tokens [total,
    dim] f32 on `device`, topics [n_topics, dim] on the host)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = int(np.sum(doclens))
    topics = torch.randn(n_topics, dim, generator=gen, device=device)
    topics = topics / topics.norm(dim=1, keepdim=True)
    ids = torch.randint(0, n_topics, (total,), generator=gen, device=device)
    toks = topics[ids] + 0.08 * torch.randn(total, dim, generator=gen, device=device)
    toks = toks / toks.norm(dim=1, keepdim=True)
    return toks, topics.cpu().numpy()


def make_queries(topics, num_queries=NUM_QUERIES, tokens=32, dim=128, seed=1):
    """Topic-mixture queries (copy of bench.py's)."""
    rng = np.random.default_rng(seed)
    queries = []
    for _ in range(num_queries):
        t = topics[rng.integers(0, len(topics), size=tokens)]
        q = (t + 0.08 * rng.standard_normal((tokens, dim))).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        queries.append(q)
    return queries


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
    the kernels line and the mutation phase's numbers."""
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index_from_device, search_batch,
    )
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8
    from nextplaid_tpu_torch.index.search import _pad_queries

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    path = os.path.join(WORK_DIR, "scifact_scale")
    try:
        doclens = make_doclens()
        tokens, topics = make_corpus(doclens, device)
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
        entries = []
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
        del pinned, unpinned, q_dev, oracle
        gc.collect()
        torch.cuda.empty_cache()
        return entries, mutation_phase(device, mk, path, topics, queries)
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
        del go, grids, scales, blocks, cand, perms
        gc.collect()
        torch.cuda.empty_cache()

        # The f32 exhaustive oracle on the first batch.
        t0 = time.perf_counter()
        full = DeviceIndex.load(path)
        oracle = search_batch(full, batches[0], SearchParameters(
            top_k=10, mode="exact", stage1_precision="highest"))
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        r_ref, r_raw = recall_at_10(refined, oracle), recall_at_10(unrefined, oracle)
        print(f"grid-only recall@10 vs the f32 exhaustive scan on {MEGA_BATCH} queries: "
              f"refined {r_ref:.4f}, unrefined {r_raw:.4f} (oracle load + scan {oracle_s:.2f} s)",
              flush=True)
        if r_ref < MIN_RECALL or r_raw < MIN_RECALL_INT8:
            raise AssertionError(f"grid-only recall@10 refined {r_ref} < {MIN_RECALL} or "
                                 f"unrefined {r_raw} < {MIN_RECALL_INT8}")
        # This slice's main path: staged search over the same full index.
        staged = staged_phase(full, device, mk, batches, queries, oracle)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        return (launches, max_err, kernel_ms, plain_ms, bound_ms, bound_by), staged
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)


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


def assert_same_topk(got, want, tol, label):
    """Score-sorted lists equal up to ties: scores within `tol`, and a doc in
    only one list must score within `tol` of the other list's last score."""
    for g, w in zip(got, want):
        if len(g.passage_ids) != len(w.passage_ids):
            raise AssertionError(f"{label}: result lengths differ")
        if not np.allclose(g.scores, w.scores, rtol=tol, atol=tol):
            raise AssertionError(f"{label}: scores differ beyond {tol}")
        g_map, w_map = dict(zip(g.passage_ids, g.scores)), dict(zip(w.passage_ids, w.scores))
        kth = w.scores[-1]
        for doc in set(g_map) ^ set(w_map):
            score = g_map.get(doc, w_map.get(doc))
            if abs(score - kth) > tol * (1 + abs(kth)):
                raise AssertionError(f"{label}: doc {doc} (score {score}) is in one top-k only")


def staged_phase(full, device, mk, batches, queries, oracle):
    """This slice's main path at full width: staged PLAID search over the
    full 473,000-doc index, stage 4 through the bf16 MaxSim kernel. Returns
    the kernel's staged numbers for the kernels line."""
    from nextplaid_tpu_torch.index import SearchParameters, search_batch, search_batch_async
    from nextplaid_tpu_torch.index import search as S
    from nextplaid_tpu_torch.index.config import resolve_target_recall

    kernel = mk.maxsim_grid_scores
    q_arr, q_mask = S._pad_queries(batches[0], full.dim)
    q_dev = torch.from_numpy(q_arr).to(device)
    m_dev = torch.from_numpy(q_mask).to(device)
    points = [(label, SearchParameters(**STAGED_COMMON, **kw), recorded - RECALL_SLACK)
              for label, kw, recorded in STAGED_POINTS]
    points.append(('preset "quality"', SearchParameters.preset("quality", **STAGED_COMMON),
                   MIN_RECALL_QUALITY))
    total_launches = 0
    for label, params, floor in points:
        resolved = resolve_target_recall(params)
        search_batch(full, batches[0], params)  # warm-up
        torch.cuda.synchronize()
        kernel.launches = 0
        pass_s, out, pending = [], None, None
        for _ in range(STAGED_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = [search_batch_async(full, batches[i % len(batches)], params)
                       for i in range(MEGA_IN_FLIGHT)]
            out = [p.result() for p in pending]
            pass_s.append(time.perf_counter() - t0)
        launches = kernel.launches
        if launches != STAGED_PASSES * MEGA_IN_FLIGHT:
            raise AssertionError(f"staged [{label}] launched the bf16 kernel {launches} times in "
                                 f"{STAGED_PASSES * MEGA_IN_FLIGHT} batches")
        total_launches += launches
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
              f"{stage['stage5']:.3f}; kernel launches {launches} (one per batch)", flush=True)
        if recall < floor:
            raise AssertionError(f"staged [{label}] recall@10 {recall} < {floor}")

    # Once: the scan route (kernel="xla") returns the same top-10.
    label, kw, _ = STAGED_POINTS[0]
    by_kernel = search_batch(full, batches[0], SearchParameters(**STAGED_COMMON, **kw))
    before = kernel.launches
    by_scan = search_batch(full, batches[0], SearchParameters(kernel="xla", **STAGED_COMMON, **kw))
    if kernel.launches != before:
        raise AssertionError('kernel="xla" launched the bf16 kernel')
    assert_same_topk(by_kernel, by_scan, STAGE4_TOL, f"staged [{label}] kernel vs scan route")
    print(f"staged [{label}]: the scan route (kernel=\"xla\") returns the same top-10 as the kernel "
          f"route (tie rule, tolerance {STAGE4_TOL})", flush=True)

    # The kernel alone at the stage-4 shape (the largest union grid), beside
    # its plain version and its bound.
    label, kw, _ = STAGED_POINTS[1]
    params = SearchParameters(**STAGED_COMMON, **kw)
    shapes = S.PipelineShapes.derive(full, params, MEGA_BATCH, q_arr.shape[1])
    k = full.num_centroids
    s_raw = (q_dev.to(torch.bfloat16).float().reshape(-1, full.dim)
             @ full.centroids.to(torch.bfloat16).float().T).view(MEGA_BATCH, -1, k)
    s_masked = s_raw.masked_fill(~m_dev[:, :, None], float("-inf"))
    cells, weights = S._dedup_cells(*S._select_cells(s_masked, m_dev, shapes, k), k)
    union_ids, _, _ = S._prune_candidates(full, cells, weights, shapes, s_masked=s_masked,
                                          qmask=m_dev, queries=q_dev)
    del s_raw, s_masked
    n_union = int((union_ids < full.num_documents).sum())
    grid, doclens = S._build_union_grid(full, union_ids, shapes)
    tq = q_arr.shape[1]
    qflat = q_dev.reshape(-1, full.dim).to(torch.bfloat16)
    args = (qflat, grid, doclens, tq)
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
    return {"staged_launches": total_launches, "staged_max_abs_err": max_err,
            "staged_ms": kernel_ms, "staged_plain_ms": plain_ms, "staged_bound_ms": bound_ms,
            "staged_bound_by": bound_by, "staged_shape": list(grid.shape)}


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

    # Phase 2: build the three kernel libraries from the sources in this
    # checkout, one nvcc each, started together.
    from nextplaid_tpu_torch.ops import maxsim_variants as mv

    t0 = time.perf_counter()
    libs = mk.build_all()
    mk._library()
    mk._library_int8()
    mv._library()
    build_s = time.perf_counter() - t0
    for lib_path in libs.values():
        log = lib_path.with_suffix(".log").read_text().splitlines()
        ptxas = [ln.strip() for ln in log if "Used" in ln]
        print(f"build: {lib_path.name}; {'; '.join(ptxas)}", flush=True)
        serialized = [ln.strip() for ln in log if "serialized" in ln]
        if serialized:
            raise AssertionError(f"{lib_path.name}: ptxas serialized wgmma: {serialized[0]}")
    print(f"build: {len(libs)} kernel sources in {build_s:.2f} s", flush=True)

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
    # Phases 5-6: SciFact scale, bf16 and int8 pins; then this slice's path,
    # mutations of that index.
    (bf16, _), mutation = scifact_phases(device, mk)
    # Phases 7-8: grid-only int8 serving at scale, then the third slice's main
    # path: staged search over the same corpus's full index.
    int8, staged = grid_only_phase(device, mk)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)

    # Phase 9: the kernels line, then the device line. The bf16 kernel's
    # launches are the SciFact path's, the staged path's and the mutation
    # phase's; its ms, bound and plain ms are the SciFact pass's, the staged_*
    # keys the stage-4 shape's. The int8 kernel's are the grid-only path's
    # and the mutation phase's.
    bf16_entry = kernel_entry("maxsim_grid_scores", "nextplaid_tpu_torch/csrc/maxsim_bf16.cu",
                              "nextplaid_tpu/ops/maxsim_kernel.py:218", *bf16[1:])
    bf16_entry.update(scifact_launches=bf16_entry["launches"], **staged, **mutation["bf16"])
    bf16_entry["launches"] += staged["staged_launches"] + mutation["bf16"]["mutation_launches"]
    int8_entry = kernel_entry("maxsim_grid_scores_int8i", "nextplaid_tpu_torch/csrc/maxsim_int8.cu",
                              "nextplaid_tpu/ops/maxsim_kernel.py:150", *int8)
    int8_entry.update(grid_only_launches=int8_entry["launches"], **mutation["int8"])
    int8_entry["launches"] += mutation["int8"]["mutation_launches"]
    print(json.dumps({"kernels": [bf16_entry, int8_entry, variants]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
