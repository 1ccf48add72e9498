"""Where the time of one search pass goes, for nextplaid_tpu_torch on a GPU.

    python scripts/profile_torch_search.py [--passes 5] [--dtype bf16|int8]

Builds the SciFact-scale index of chip_smoke.py on the card, pins the bf16
(or int8) grid, and runs `search_batch` over 320 queries under
torch.profiler. Prints
the device time of each kernel per pass, the pass's wall time, and the
share of it the device sat idle, as one JSON line. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (corpus and query generators)
from nextplaid_tpu_torch.index import (  # noqa: E402
    DeviceIndex,
    IndexConfig,
    SearchParameters,
    create_index_from_device,
    search_batch,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--dtype", choices=("bf16", "int8"), default="bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_search: CUDA is not available", file=sys.stderr)
        return 1
    work = os.path.join(ROOT, "build", "profile_torch_search")
    shutil.rmtree(work, ignore_errors=True)
    try:
        doclens = chip_smoke.make_doclens()
        tokens, topics = chip_smoke.make_corpus(doclens, torch.device("cuda"))
        create_index_from_device(tokens, doclens, work, IndexConfig(nbits=4, seed=42))
        del tokens
        index = DeviceIndex.load(work).with_token_grid(dtype=args.dtype)
        queries = chip_smoke.make_queries(topics)
        params = SearchParameters(top_k=10, stage1_precision="default")
        search_batch(index, queries, params)  # warm-up (and kernel build)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.passes):
                search_batch(index, queries, params)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / args.passes
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # Device time of kernels and copies (profiler times are in us).
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time / 1e3
    per_pass = {k: v / args.passes for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    busy_ms = sum(per_pass.values())
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "grid": args.dtype,
        "passes": args.passes,
        "wall_ms_per_pass": wall_ms,
        "device_busy_ms_per_pass": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_per_pass_by_kernel": dict(list(per_pass.items())[:12]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
