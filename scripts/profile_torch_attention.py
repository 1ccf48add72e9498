"""Check and time the packed attention kernel (`ops/attention.py`'s Triton
`varlen_attention_kernel`) beside its plain version, on one NVIDIA GPU, at
the rerank cell's shapes.

    python3 scripts/profile_torch_attention.py [--reps 20] [--plain-reps 2]

Draws a request's 32 document lengths as the cell does (log-normal, median
1,024 tokens, sigma 1.0, clipped to 64-8,192; seed 7) and adds one of
8,192 tokens; q, k, v [N, 12, 64] bf16 are random (the time depends on
the lengths, not the values). For a global layer (theta 160,000) and a
local one (half window 64, theta 10,000), each with RoPE as the encoder
calls it, checks the kernel against the plain version (least cosine per
token and head) and prints one JSON line each: the kernel's and the plain
version's ms a launch (CUDA events), the operations and bytes the launch
needs (`benchmark/plaidbench/encoder_work.py`'s counting) and their time
at 989 TFLOP/s and 3.35 TB/s, and the card's name and power limit. Needs
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nextplaid_tpu_torch.encoder.model import _rope_tables, packed_positions  # noqa: E402
from nextplaid_tpu_torch.ops import attention as A  # noqa: E402

PEAK_BF16 = 989e12
HBM_BYTES_S = 3.35e12
HEADS, HEAD_DIM = 12, 64


def lengths(seed=7):
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(1024 * np.exp(rng.standard_normal(32))), 64, 8192).astype(np.int64)
    return np.sort(np.append(lens, 8192))


def time_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plain-reps", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    lens = lengths()
    n = int(lens.sum())
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=dev)
    pos = torch.from_numpy(packed_positions(lens)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(n, HEADS, HEAD_DIM, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    tiles = A.tile_table(cu, n)
    w = 64
    band = np.where(lens <= w + 1, lens * lens, lens * (2 * w + 1) - w * (w + 1))
    for half_window, theta, pairs in ((None, 160_000.0, int((lens * lens).sum())),
                                      (w, 10_000.0, int(band.sum()))):
        rope = _rope_tables(pos, HEAD_DIM, theta)
        got = A.varlen_attention(q, k, v, cu, half_window, 0.125, rope=rope, tiles=tiles)
        want = A.varlen_attention_reference(q, k, v, cu, half_window, 0.125, rope=rope)
        a, b = got.double().reshape(-1, HEAD_DIM), want.double().reshape(-1, HEAD_DIM)
        cos = float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())
        del want, a, b
        kernel = time_ms(lambda: A.varlen_attention(q, k, v, cu, half_window, 0.125,
                                                    rope=rope, tiles=tiles), args.reps)
        plain = time_ms(lambda: A.varlen_attention_reference(q, k, v, cu, half_window, 0.125,
                                                             rope=rope), args.plain_reps)
        ops = 4.0 * HEADS * HEAD_DIM * pairs
        nbytes = 4.0 * 2 * n * HEADS * HEAD_DIM
        print(json.dumps({
            "layer": "global" if half_window is None else "local", "tokens": n,
            "documents": len(lens), "least_cosine": cos, "kernel_ms": kernel, "plain_ms": plain,
            "ops": ops, "bytes": nbytes, "ops_ms": 1e3 * ops / PEAK_BF16,
            "bytes_ms": 1e3 * nbytes / HBM_BYTES_S,
            "roofline_pct": 100 * 1e3 * max(ops / PEAK_BF16, nbytes / HBM_BYTES_S) / kernel,
            "card": card,
        }), flush=True)
        if cos < 0.999:
            raise AssertionError(f"kernel against plain: least cosine {cos}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
