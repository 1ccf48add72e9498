"""Build, check and time the staged route's union grid kernel
(csrc/union_grid.cu) beside the eager loop it replaced, on one NVIDIA GPU,
without building an index.

    python3 scripts/profile_torch_union_grid.py [--reps 20] [--eager-reps 3]

Makes the decompression tensors of an index shaped as LoTTE Lifestyle's
(119,461 docs of 100-220 tokens, 19.1M tokens, K 65,536, d 128, nbits 2;
random codes, residuals and centroids: the time depends on the shapes and
the doc lengths, not on the values) and a staged batch's union at the
stage-4 shape: 65,536 rows x Td 224, 48,300 of them docs (about the live
share staged batches show there), the rest sentinels. Prints what ptxas
reports, checks the kernel's grid against the eager one (doclens and zero
rows exact, live elements within one bf16 ulp), then prints one JSON line:
the kernel's and the eager loop's ms a build (CUDA events), the bytes the
build must move and their time at 3.35 TB/s, and the card's name and power
limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nextplaid_tpu_torch.index import DeviceIndex  # noqa: E402
from nextplaid_tpu_torch.index import search as S  # noqa: E402
from nextplaid_tpu_torch.ops import union_grid as U  # noqa: E402
from nextplaid_tpu_torch.ops.maxsim_kernel import BUILD_DIR, build_tag  # noqa: E402

HBM_BYTES_S = 3.35e12
DOCS, K, DIM, NBITS, TD, ROWS, LIVE_DOCS = 119_461, 65_536, 128, 2, 224, 65_536, 48_300


def lotte_index(device, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.zeros(DOCS + 1, np.int32)  # one padded row: the pipeline's sentinel
    lens[:DOCS] = rng.integers(100, 221, DOCS)
    offsets = np.zeros(DOCS + 2, np.int32)
    np.cumsum(lens, out=offsets[1:])
    ntok = int(offsets[-1])
    gen = torch.Generator(device=device).manual_seed(seed)
    cents = torch.randn(K, DIM, generator=gen, device=device)
    return DeviceIndex(
        centroids=cents / cents.norm(dim=1, keepdim=True),
        codes=torch.randint(0, K, (ntok,), generator=gen, device=device, dtype=torch.int32),
        residuals=torch.randint(0, 256, (ntok, DIM * NBITS // 8), generator=gen,
                                device=device, dtype=torch.uint8),
        doc_offsets=torch.from_numpy(offsets).to(device),
        doclens=torch.from_numpy(lens).to(device),
        ivf_offsets=torch.zeros(K + 1, dtype=torch.int32, device=device),
        ivf_doc_ids=torch.zeros(0, dtype=torch.int32, device=device),
        bucket_cutoffs=torch.tensor([-0.02, 0.0, 0.02], device=device),
        bucket_weights=torch.tensor([-0.04, -0.01, 0.01, 0.04], device=device),
        avg_residual=torch.zeros(DIM, device=device),
        n_docs=DOCS, n_emb=int(lens.sum()), nbits=NBITS, max_doclen=int(lens.max()),
    )


def union(device, seed=1):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(DOCS, LIVE_DOCS, replace=False))
    ids = np.concatenate([ids, np.full(ROWS - LIVE_DOCS, DOCS)])
    return torch.from_numpy(ids).to(device)


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--eager-reps", type=int, default=3)
    args = ap.parse_args()
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    U._library()
    print((BUILD_DIR / f"union_grid-{build_tag(U.SOURCE)}.log").read_text())
    index, ids = lotte_index(device), union(device)
    shapes = types.SimpleNamespace(doc_token_cap=TD)

    grid, lens = S._build_union_grid(index, ids, shapes)
    want_grid, want_lens = S._build_union_grid_eager(index, ids, shapes)
    live = torch.arange(TD, device=device)[None, :] < lens[:, None]
    ulps = (grid[live].view(torch.int16).int() - want_grid[live].view(torch.int16).int()).abs()
    check = {
        "doclens_equal": bool(torch.equal(lens, want_lens)),
        "dead_nonzero": int(torch.count_nonzero(grid[~live])),
        "bit_identical_share": float((ulps == 0).double().mean()),
        "max_ulp": int(ulps.max()),
    }
    del grid, want_grid, live, ulps
    torch.cuda.empty_cache()

    live_tokens = int(lens.sum())
    packed = DIM * NBITS // 8
    grid_bytes = ROWS * TD * DIM * 2
    read_bytes = live_tokens * (4 + packed) + K * DIM * 4 + ROWS * 12
    kernel_ms = time_ms(lambda: S._build_union_grid(index, ids, shapes), args.reps)
    eager_ms = time_ms(lambda: S._build_union_grid_eager(index, ids, shapes), args.eager_reps)
    bound_ms = (grid_bytes + read_bytes) / HBM_BYTES_S * 1e3
    print(json.dumps({
        "card": card, "shape": [ROWS, TD, DIM], "nbits": NBITS, "live_tokens": live_tokens,
        "live_share": live_tokens / (ROWS * TD), "check": check,
        "kernel_ms": round(kernel_ms, 4), "eager_ms": round(eager_ms, 3),
        "bytes": grid_bytes + read_bytes, "bound_ms": round(bound_ms, 4),
        "kernel_share_of_bound": round(bound_ms / kernel_ms, 4),
    }))
    ok = check["doclens_equal"] and check["dead_nonzero"] == 0 and check["max_ulp"] <= 1
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
