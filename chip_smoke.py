"""Smoke run of nextplaid_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's main path once at SciFact scale (5,183 docs, doclens
64-300, ~1.5M tokens, d 128, nbits 4, 16,384 centroids): a corpus made on
the card from a seed, `create_index_from_device`, `DeviceIndex.load`,
`with_token_grid(dtype="bf16")` and `search_batch` over 320 queries, with
recall@10 against the f32 exhaustive oracle. Before that it builds the CUDA
MaxSim kernel from the sources in this checkout and holds it against its
plain PyTorch version on the card.

Prints one line per phase, then a {"kernels": [...]} JSON line, and as its
last line {"ok": true, "device": {...}}. Exits non-zero, with no result,
when CUDA is unavailable or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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

# H100 SXM published peaks (dense bf16 tensor cores, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain version: both sum exact bf16 products in f32, in other
# orders; allowed |difference| is this fraction of the largest |score|.
KERNEL_RTOL = 1e-4
MIN_RECALL = 0.99
NUM_QUERIES = 320
TIMED_PASSES = 10


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 1
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index_from_device, search_batch,
    )
    from nextplaid_tpu_torch.index.search import _pad_queries
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    device = torch.device("cuda")
    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible", flush=True)

    # Phase 2: build the kernel library from the sources in this checkout.
    t0 = time.perf_counter()
    lib_path = mk.build_library()
    mk._library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "Used" in ln]
    print(f"build: {lib_path.name} in {build_s:.2f} s; {'; '.join(ptxas)}", flush=True)

    # Phase 3: kernel vs plain version on the card.
    for label, args in (("edge cases", edge_case_inputs(device)),
                        ("main-path slice 64q x 512 docs", slice_inputs(device))):
        check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference, args, label)

    # Phase 4: the main path end to end at SciFact scale.
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
        params = SearchParameters(top_k=10, stage1_precision="default")
        search_batch(index, queries, params)  # warm-up
        mk.maxsim_grid_scores.launches = 0
        pass_s, results = [], None
        for _ in range(TIMED_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = search_batch(index, queries, params)
            pass_s.append(time.perf_counter() - t0)
        launches = mk.maxsim_grid_scores.launches
        if launches < TIMED_PASSES:
            raise AssertionError(
                f"the main path launched the kernel {launches} times in {TIMED_PASSES} passes"
            )
        if len(results) != NUM_QUERIES or any(
            len(r.passage_ids) != 10 or not np.all(np.isfinite(r.scores))
            or np.any(np.diff(r.scores) > 0) for r in results
        ):
            raise AssertionError("search results are not 10 finite, sorted hits per query")
        qps = [NUM_QUERIES / s for s in pass_s]

        n_eval = 64
        oracle = search_batch(unpinned, queries[:n_eval],
                              SearchParameters(top_k=10, mode="exact", stage1_precision="highest"))
        recall = float(np.mean([
            len(set(r.passage_ids) & set(o.passage_ids)) / max(len(o.passage_ids), 1)
            for r, o in zip(results[:n_eval], oracle)
        ]))

        # The kernel alone at the main path's shapes, beside its plain version.
        q_arr, _ = _pad_queries(queries, index.dim)
        tq = q_arr.shape[1]
        qflat = torch.from_numpy(q_arr.reshape(-1, index.dim)).to(device, torch.bfloat16)
        doclens_g = torch.zeros(grid.shape[0], dtype=torch.int32, device=device)
        doclens_g[: index.num_docs_padded] = index.doclens
        args = (qflat, grid, doclens_g, tq)
        max_err = check_kernel(mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference, args,
                               f"main path {NUM_QUERIES}q x {grid.shape[0]} rows")
        kernel_ms = time_ms(lambda: mk.maxsim_grid_scores(*args), reps=20)
        plain_ms = time_ms(lambda: mk.maxsim_grid_scores_reference(*args), reps=3)
        bound_ms, bound_by, dense_ms = maxsim_bound(qflat, grid, doclens_g, tq)
        print(f"search: {NUM_QUERIES} queries x {TIMED_PASSES} passes, "
              f"p50 {statistics.median(qps):.1f} QPS (min {min(qps):.1f}, max {max(qps):.1f}); "
              f"kernel {kernel_ms:.3f} ms/pass, bound {bound_ms:.3f} ms "
              f"({bound_by}; {100 * bound_ms / kernel_ms:.1f}% of it), dense-grid "
              f"bound {dense_ms:.3f} ms; plain version {plain_ms:.3f} ms; recall@10 vs f32 oracle "
              f"{recall:.4f} on {n_eval} queries; kernel launches {launches}", flush=True)
        if recall < MIN_RECALL:
            raise AssertionError(f"recall@10 {recall} < {MIN_RECALL}")
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    # Phase 5: the kernels line, then the device line.
    print(json.dumps({"kernels": [{
        "name": "maxsim_grid_scores",
        "route": "cuda",
        "source": "nextplaid_tpu_torch/csrc/maxsim_bf16.cu",
        "replaces": "nextplaid_tpu/ops/maxsim_kernel.py:218",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
