"""Build, check and time the two served MaxSim kernels of nextplaid_tpu_torch
on one NVIDIA GPU, without building an index.

    python3 scripts/profile_torch_maxsim.py [--check-only] [--reps 10] [--clocks]

Builds csrc/maxsim_bf16.cu and csrc/maxsim_int8.cu (both include
csrc/maxsim_wgmma.cuh), prints what ptxas reports (registers, spills,
warnings), holds each kernel against its plain version on chip_smoke.py's
edge and tiling cases, and then times each at synthetic grids shaped as the
main paths' (random unit tokens; the times depend on the shapes and the
doc lengths, not on the values):
  - bf16, SciFact pass: 10,240 query tokens x [5696, 304, 128], doclens
    N(290, 40) clipped to 64-300;
  - bf16, staged stage 4: 2,048 query tokens x [65536, 224, 128], doclens
    uniform 100-220, 8% of the rows empty;
  - bf16, the variant sweep's shape: 2,048 x [5184, 384, 128];
  - int8, the `lotte.int8.window2` cell: 2,048 query tokens x the pinned
    LoTTE grid [119461, 224, 128], doclens uniform 100-220 (bound 5.06 ms);
  - int8, one grid-only bucket: 64 queries and 1 query x [118272, 160, 128];
  - int8, SciFact pass: 10,240 x [5760, 320, 128].
Each time stands beside its bound (the valid tokens' products at the card's
peak, or the bytes at its memory rate) and the share of rows multiplied
that lie past the doc's length (the cost of 64-row tiles).

At the LoTTE cell's shape it also times the int8 dots-only probe
(csrc/maxsim_int8_probe.cu) at the served plan, the products and feed
alone with no wait inside the walk, beside the served kernel: the gap is
what the schedule's waits and its scale-and-max cost. (The third time of
the split, each tile's products waited for but no max taken, was 10.1 ms
against 7.7 and 13.9 on an H100 80GB HBM3 at 700 W; PERF.md keeps it.)
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def bf16_inputs(device, q_n, nd, td, lens, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(q_n * 32, 128, generator=gen, device=device)
    q = (q / q.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    grid = torch.randn(nd, td, 128, generator=gen, device=device)
    grid = (grid / grid.norm(dim=2, keepdim=True)).to(torch.bfloat16)
    lens = torch.from_numpy(lens.astype(np.int32)).to(device)
    grid = grid * (torch.arange(td, device=device)[None, :] < lens[:, None])[:, :, None]
    return q, grid.contiguous(), lens, 32


def int8_inputs(device, q_n, nd, td, lens, seed):
    from nextplaid_tpu_torch.index.container import quantize_tokens_int8
    from nextplaid_tpu_torch.index.exact import quantize_queries_int8

    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(q_n * 32, 128, generator=gen, device=device)
    qi8, qs = quantize_queries_int8(q / q.norm(dim=1, keepdim=True))
    lens = torch.from_numpy(lens.astype(np.int64)).to(device)
    valid = torch.arange(td, device=device)[None, :] < lens[:, None]
    grids, scales = [], []
    for s in range(0, nd, 8192):  # quantize in pieces: the f32 tokens are large
        emb = torch.randn(min(8192, nd - s), td, 128, generator=gen, device=device)
        v = valid[s : s + 8192]
        emb = torch.where(v[:, :, None], emb / emb.norm(dim=2, keepdim=True), 0.0)
        g, sc = quantize_tokens_int8(emb, v)
        grids.append(g)
        scales.append(sc)
    return qi8, qs, torch.cat(grids), torch.cat(scales), 32


def int8_probe_ms(mk, a, reps):
    """Device ms of the int8 dots-only probe (the products and feed alone)
    at the served plan of the int8 inputs `a`."""
    import ctypes

    lib = ctypes.CDLL(str(mk.build_library(mk.SOURCE_INT8_PROBE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_int8_probe_scores.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
    lib.maxsim_int8_probe_error_string.restype = ctypes.c_char_p
    q, qs, grid, scales, tq = a
    q_n, (nd, td, d) = q.shape[0] // tq, grid.shape
    plan = mk.plan_launch(q_n, tq, nd, d, scales=True)
    out = torch.empty(q_n, nd, dtype=torch.float32, device=grid.device)

    def launch():
        err = lib.maxsim_int8_probe_scores(
            q.data_ptr(), qs.data_ptr(), grid.data_ptr(), scales.data_ptr(), out.data_ptr(),
            q_n, tq, nd, td, d, plan.n, plan.n_wg, plan.dpb, plan.stages,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"int8 probe: {lib.maxsim_int8_probe_error_string(err)}")

    return cs.time_ms(launch, reps)


def clocks_under_load(fn, seconds=3.0):
    """Run `fn` back to back for `seconds` and sample the SM clock and the
    power draw meanwhile. Returns the samples as nvidia-smi prints them."""
    import threading
    import time

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True).stdout.strip()
            samples.append(out)
            time.sleep(0.3)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    return samples


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--clocks", action="store_true",
                    help="sample the SM clock and power while a kernel runs back to back")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_maxsim: CUDA is not available", file=sys.stderr)
        return 1
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for src in (mk.SOURCE, mk.SOURCE_INT8, mk.SOURCE_INT8_PROBE):
        lib = mk.build_library(src)
        log = lib.with_suffix(".log").read_text().splitlines()
        for i, ln in enumerate(log):
            if "Compiling entry function" in ln and "maxsim_kernel" in ln:
                inst = ln.split("maxsim_kernel")[1][:24]
                used = next((x.strip() for x in log[i : i + 4] if "Used" in x), "")
                spill = next((x.strip() for x in log[i : i + 4] if "spill" in x), "")
                print(f"ptxas {src.name} {inst}: {used}; {spill}", flush=True)
        for ln in log:
            if "warning" in ln.lower() or "serialized" in ln.lower():
                print(f"ptxas {src.name} WARNING: {ln.strip()}", flush=True)

    bf16, bf16_ref = mk.maxsim_grid_scores, mk.maxsim_grid_scores_reference
    int8, int8_ref = mk.maxsim_grid_scores_int8i, mk.maxsim_grid_scores_int8i_reference
    cs.check_kernel(bf16, bf16_ref, cs.edge_case_inputs(device), "bf16 edge cases")
    cs.check_kernel(bf16, bf16_ref, cs.slice_inputs(device), "bf16 main-path slice")
    cs.check_kernel(int8, int8_ref, cs.int8_edge_inputs(device), "int8 edge cases")
    cs.check_kernel(int8, int8_ref, cs.int8_slice_inputs(device), "int8 main-path slice")
    for case in cs.TILING_CASES:
        cs.check_kernel(bf16, bf16_ref, cs.tiling_case_bf16(case, device), f"bf16 tiling: {case[0]}")
        cs.check_kernel(int8, int8_ref, cs.tiling_case_int8(case, device), f"int8 tiling: {case[0]}")
    if args.check_only:
        return 0

    rng = np.random.default_rng(0)
    scifact = np.zeros(5696, np.int64)
    scifact[:5183] = cs.make_doclens()
    stage4 = rng.integers(100, 221, 65536)
    stage4[rng.random(65536) < 0.08] = 0
    sweep = rng.integers(64, 384, 5184)
    sweep[::7] = 0
    for label, q_n, nd, td, lens in (
        ("bf16 SciFact pass", 320, 5696, 304, scifact),
        ("bf16 stage-4 shape", 64, 65536, 224, stage4),
        ("bf16 sweep shape", 64, 5184, 384, sweep),
        ("bf16 one query, stage-4 grid", 1, 65536, 224, stage4),
    ):
        a = bf16_inputs(device, q_n, nd, td, lens, seed=1)
        plan = mk.plan_launch(q_n, 32, nd, 256, scales=False)
        if nd <= 8192:
            cs.check_kernel(bf16, bf16_ref, a, label)
        ms = cs.time_ms(lambda: bf16(*a), args.reps)
        bound, by, _ = cs.maxsim_bound(*a)
        print(f"time [{label}]: {ms:.3f} ms, bound {bound:.3f} ms ({by}; {100 * bound / ms:.1f}% "
              f"of it), tile waste {100 * cs.tile_waste(np.minimum(lens, td)):.1f}%, plan {plan}", flush=True)
        if args.clocks and label == "bf16 SciFact pass":
            print(f"clocks under load [{label}]: {clocks_under_load(lambda: bf16(*a))}", flush=True)
        del a
    bucket = rng.integers(130, 161, 118272)
    lotte = rng.integers(100, 221, 119461)
    scifact8 = np.zeros(5760, np.int64)
    scifact8[:5183] = cs.make_doclens()
    for label, q_n, nd, td, lens in (
        ("int8 LoTTE cell, 64 queries", 64, 119461, 224, lotte),
        ("int8 grid-only bucket, 64 queries", 64, 118272, 160, bucket),
        ("int8 grid-only bucket, 1 query", 1, 118272, 160, bucket),
        ("int8 SciFact pass", 320, 5760, 320, scifact8),
    ):
        a = int8_inputs(device, q_n, nd, td, lens, seed=2)
        plan = mk.plan_launch(q_n, 32, nd, 128, scales=True)
        if nd <= 8192:
            cs.check_kernel(int8, int8_ref, a, label)
        ms = cs.time_ms(lambda: int8(*a), args.reps)
        bound, by = cs.maxsim_bound_int8(a[0], [a[2]], [a[3]], q_n)
        print(f"time [{label}]: {ms:.3f} ms, bound {bound:.3f} ms ({by}; {100 * bound / ms:.1f}% "
              f"of it), tile waste {100 * cs.tile_waste(np.minimum(lens, td)):.1f}%, plan {plan}", flush=True)
        if label == "int8 LoTTE cell, 64 queries":
            probe_ms = int8_probe_ms(mk, a, args.reps)
            print(f"int8 probe [{label}] products, no wait: {probe_ms:.3f} ms "
                  f"({100 * bound / probe_ms:.1f}% of the bound); served kernel {ms:.3f} ms",
                  flush=True)
        if args.clocks and label in ("int8 SciFact pass", "int8 LoTTE cell, 64 queries"):
            print(f"clocks under load [{label}]: {clocks_under_load(lambda: int8(*a))}", flush=True)
        del a
    return 0


if __name__ == "__main__":
    sys.exit(main())
