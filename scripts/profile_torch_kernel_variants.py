"""Sweep the MaxSim kernel variants of nextplaid_tpu_torch on an NVIDIA GPU.

    python3 scripts/profile_torch_kernel_variants.py [--check-only] [--reps 6]

The counterpart of scripts/profile_kernel_variants.py: the same shape (5184
docs x Td 384 x d 128, SWEEP_Q (64) queries x 32 tokens, every seventh doc
empty, lengths 64-383 from numpy seed 0), grid and queries made on the card.
Builds csrc/maxsim_variants.cu (instances of the wgmma/TMA template of
csrc/maxsim_wgmma.cuh) and prints what ptxas reports for each instance
(registers, spills, warnings). Then holds every variant against its plain
version at the sweep's shape, with its launch plan (N, warpgroups, ring
stages, rows a stage, docs a block); `--check-only` stops there, the right
first call after an edit to the kernel. Otherwise prints the masked-scan
baseline (the plain PyTorch version), the one-big-dot floor (bf16
torch.matmul tiled over docs with a per-doc sum: the probe's function) and
one line per variant with min / median ms by CUDA events, the share of its
own bound (the valid rows' products at 989 TFLOP/s for MaxSim, every row's
for the probe) and, for the probe, its ratio to the floor. A variant that
fails to build, launch or agree raises.

VARIANTS=lens,dots keeps the variants whose name contains one of the tokens.
"""

import argparse
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nextplaid_tpu_torch.ops.maxsim_kernel import SOURCE_VARIANTS, build_library  # noqa: E402
from nextplaid_tpu_torch.ops.maxsim_variants import (  # noqa: E402
    SWEEP_SHAPE,
    SWEEP_VARIANTS,
    maxsim_variant_scores,
    maxsim_variant_scores_reference,
    one_big_dot_floor,
    sweep_inputs,
    variant_plan,
)

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
RTOL = 1e-4  # of the largest |score|: exact bf16 products, f32 sums reordered
RTOL_DOTS = 1e-3  # the probe sums ~1e6 products per output in other orders


def time_ms(fn, reps):
    """(min, median) device ms of `fn` over `reps` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), statistics.median(times)


def ptxas_report(lib):
    """One line per kernel instance of a build log: registers and spills,
    then any warning."""
    log = lib.with_suffix(".log").read_text().splitlines()
    lines = []
    for i, ln in enumerate(log):
        if "Compiling entry function" in ln:
            used = next((x.strip() for x in log[i : i + 4] if "Used" in x), "")
            spill = next((x.strip() for x in log[i : i + 4] if "spill" in x), "")
            inst = ln.split("maxsim_kernel")[-1].split("v14CUtensorMap")[0]  # mangled args
            lines.append(f"ptxas {inst}: {used}; {spill}")
    lines += [f"ptxas WARNING: {ln.strip()}" for ln in log
              if "warning" in ln.lower() or "serialized" in ln.lower()]
    return lines


def plan_text(plan):
    return (f"N {plan.n} x {plan.n_wg} wg, {plan.stages} stages of {plan.rows} rows, "
            f"{plan.dpb} docs a block")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    for line in ptxas_report(build_library(SOURCE_VARIANTS)):
        print(line, flush=True)
    q_n = int(os.environ.get("SWEEP_Q", "64"))
    tq = SWEEP_SHAPE["tq"]
    qflat, grid, lens, addmask = sweep_inputs(device, q_n)
    valid_rows = int(lens.sum())
    all_rows = grid.shape[0] * grid.shape[1]
    flop = 2.0 * qflat.shape[0] * grid.shape[2]
    bound_ms = 1e3 * flop * valid_rows / PEAK_BF16_FLOPS
    probe_bound_ms = 1e3 * flop * all_rows / PEAK_BF16_FLOPS
    print(f"shape: {q_n} queries x {tq} tokens, grid {tuple(grid.shape)} bf16, "
          f"{valid_rows} valid rows of {all_rows}; bound {bound_ms:.3f} ms (valid rows' "
          f"products at 989 TFLOP/s), probe's bound {probe_bound_ms:.3f} ms (every row's)",
          flush=True)

    only = [tok for tok in os.environ.get("VARIANTS", "").split(",") if tok]
    chosen = [v for v in SWEEP_VARIANTS if not only or any(tok in v[0] for tok in only)]
    want = {False: maxsim_variant_scores_reference(qflat, grid, lens, tq)}
    for name, mask, geometry, reduce, dots in chosen:
        arg = addmask if mask == "additive" else lens
        kw = dict(mask=mask, geometry=geometry, reduce=reduce, dots_only=dots)
        ref_key = geometry[0] if dots else False
        if ref_key not in want:
            want[ref_key] = maxsim_variant_scores_reference(qflat, grid, arg, tq, **kw)
        got = maxsim_variant_scores(qflat, grid, arg, tq, **kw)
        torch.cuda.synchronize()
        ref = want[ref_key]
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-9)
        tol = RTOL_DOTS if dots else RTOL
        if not (torch.isfinite(got).all() and rel <= tol):
            raise AssertionError(f"{name}: max relative error {rel} > {tol}")
        plan = variant_plan(q_n, tq, grid.shape[2], **kw)
        print(f"check {name:18s} maxrelerr={rel:.2e}  plan: {plan_text(plan)}", flush=True)
    if args.check_only:
        return 0

    tmin, tmed = time_ms(lambda: maxsim_variant_scores_reference(qflat, grid, lens, tq), reps=3)
    print(f"{'plain masked scan':32s} {tmin:8.3f} ms min / {tmed:8.3f} med", flush=True)
    floor_min, floor_med = time_ms(lambda: one_big_dot_floor(qflat, grid), args.reps)
    print(f"{'one-big-dot floor (torch.matmul)':32s} {floor_min:8.3f} ms min / {floor_med:8.3f} "
          f"med", flush=True)
    for name, mask, geometry, reduce, dots in chosen:
        arg = addmask if mask == "additive" else lens
        kw = dict(mask=mask, geometry=geometry, reduce=reduce, dots_only=dots)
        tmin, tmed = time_ms(lambda: maxsim_variant_scores(qflat, grid, arg, tq, **kw), args.reps)
        own = probe_bound_ms if dots else bound_ms
        extra = f", {tmed / floor_med:.2f} x the floor" if dots else ""
        print(f"{name:32s} {tmin:8.3f} ms min / {tmed:8.3f} med  {100 * own / tmed:5.1f}% of "
              f"its bound {own:.3f} ms{extra}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
