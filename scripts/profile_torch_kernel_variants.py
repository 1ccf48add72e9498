"""Sweep the MaxSim kernel variants of nextplaid_tpu_torch on an NVIDIA GPU.

The counterpart of scripts/profile_kernel_variants.py: the same shape (5184
docs x Td 384 x d 128, SWEEP_Q (64) queries x 32 tokens, every seventh doc
empty, lengths 64-383 from numpy seed 0), grid and queries made on the card.
Prints the masked-scan baseline (the plain PyTorch version), the
one-big-dot floor (bf16 torch.matmul tiled over docs with a per-doc sum: the
same contraction with no mask, max or epilogue) and one line per variant of
csrc/maxsim_variants.cu with min / median ms by CUDA events and the largest
error relative to the largest |score| of the plain version. A variant that
fails to build, launch or agree raises.

Run on the card: python3 scripts/profile_torch_kernel_variants.py
VARIANTS=lens,dots keeps the variants whose name contains one of the tokens.
"""

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nextplaid_tpu_torch.ops.maxsim_variants import (  # noqa: E402
    SWEEP_SHAPE,
    SWEEP_VARIANTS,
    maxsim_variant_scores,
    maxsim_variant_scores_reference,
    one_big_dot_floor,
    sweep_inputs,
)

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
REPS = 6
RTOL = 1e-4  # of the largest |score|: exact bf16 products, f32 sums reordered
RTOL_DOTS = 1e-3  # the probe sums ~1e6 products per output in other orders


def time_ms(fn, reps=REPS):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    q_n = int(os.environ.get("SWEEP_Q", "64"))
    tq = SWEEP_SHAPE["tq"]
    qflat, grid, lens, addmask = sweep_inputs(device, q_n)
    valid_rows = int(lens.sum())
    bound_ms = 1e3 * 2.0 * qflat.shape[0] * grid.shape[2] * valid_rows / PEAK_BF16_FLOPS
    print(f"shape: {q_n} queries x {tq} tokens, grid {tuple(grid.shape)} bf16, "
          f"{valid_rows} valid rows; bound {bound_ms:.3f} ms (valid rows' products at "
          f"989 TFLOP/s)", flush=True)

    want = {False: maxsim_variant_scores_reference(qflat, grid, lens, tq)}
    tmin, tmed = time_ms(lambda: maxsim_variant_scores_reference(qflat, grid, lens, tq), reps=3)
    print(f"{'plain masked scan':32s} {tmin:8.3f} ms min / {tmed:8.3f} med", flush=True)
    tmin, tmed = time_ms(lambda: one_big_dot_floor(qflat, grid))
    print(f"{'one-big-dot floor (torch.matmul)':32s} {tmin:8.3f} ms min / {tmed:8.3f} med",
          flush=True)

    only = [tok for tok in os.environ.get("VARIANTS", "").split(",") if tok]
    for name, mask, geometry, reduce, dots in SWEEP_VARIANTS:
        if only and not any(tok in name for tok in only):
            continue
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
        if not rel <= tol:
            raise AssertionError(f"{name}: max relative error {rel} > {tol}")
        tmin, tmed = time_ms(lambda: maxsim_variant_scores(qflat, grid, arg, tq, **kw))
        print(f"{name:32s} {tmin:8.3f} ms min / {tmed:8.3f} med   maxrelerr={rel:.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
