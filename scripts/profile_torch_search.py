"""Where the time of one search pass goes, for nextplaid_tpu_torch on a GPU.

    python scripts/profile_torch_search.py [--passes 5] [--dtype bf16|int8]
    python scripts/profile_torch_search.py [--grid-only] [--staged] [--docs 473000] [--keep 1024]

Builds the SciFact-scale index of chip_smoke.py on the card, pins the bf16
(or int8) grid, and runs `search_batch` over 320 queries under
torch.profiler. With --grid-only and/or --staged it builds chip_smoke.py's
megascale corpus instead, once (the 473,000-doc build takes minutes), and
profiles passes of 6 batches of 64 queries in flight: --grid-only through
`load_grid_only(dtype="int8")` with the device refine, --staged through the
unpinned index (cells, nprobe 8, `--keep`). Prints the card's name and power
limit, then for each path one JSON line: the device time of each kernel per
pass, the pass's wall time, and the share of it the device sat idle. Needs
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import gc
import shutil
import subprocess
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
    create_index_streamed,
    load_grid_only,
    search_batch,
    search_batch_async,
)


def profile(run_pass, passes, path):
    """Run `passes` passes under torch.profiler and print one JSON line."""
    run_pass()  # warm-up (and kernel build)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            run_pass()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / passes
    # Device time of kernels and copies (profiler times are in us). Names are
    # cut to 90 characters (PyTorch's templated kernels run to hundreds);
    # kernels whose cut names agree are summed.
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name if len(evt.name) <= 90 else evt.name[:87] + "..."
            by_name[name] = by_name.get(name, 0.0) + evt.device_time / 1e3
    per_pass = {k: v / passes for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}
    busy_ms = sum(per_pass.values())
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": path,
        "passes": passes,
        "wall_ms_per_pass": wall_ms,
        "device_busy_ms_per_pass": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_per_pass_by_kernel": dict(list(per_pass.items())[:16]),
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--dtype", choices=("bf16", "int8"), default="bf16")
    ap.add_argument("--staged", action="store_true")
    ap.add_argument("--grid-only", action="store_true")
    ap.add_argument("--docs", type=int, default=chip_smoke.MEGA_DOCS)
    ap.add_argument("--keep", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_search: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    work = os.path.join(ROOT, "build", "profile_torch_search")
    shutil.rmtree(work, ignore_errors=True)
    try:
        if args.staged or args.grid_only:
            chunks, sample, lens, topics = chip_smoke.mega_corpus(device, args.docs)
            create_index_streamed(
                chunks, work, IndexConfig(nbits=2, seed=42),
                sample_tokens=sample, est_total_tokens=int(lens.sum()),
            )
            del sample, chunks
            gc.collect()
            torch.cuda.empty_cache()
            queries = chip_smoke.mega_queries(topics)
            batch = chip_smoke.MEGA_BATCH
            batches = [queries[s : s + batch] for s in range(0, len(queries), batch)]
            shape = (f"{args.docs} docs, {chip_smoke.MEGA_IN_FLIGHT} batches of "
                     f"{chip_smoke.MEGA_BATCH} a pass")

            def passes_of(index, params):
                def run_pass():
                    pending = [search_batch_async(index, batches[i % len(batches)], params)
                               for i in range(chip_smoke.MEGA_IN_FLIGHT)]
                    return [p.result() for p in pending]
                return run_pass

            if args.grid_only:
                index = load_grid_only(work, dtype="int8")
                params = SearchParameters(top_k=10, stage1_precision="default")
                profile(passes_of(index, params), args.passes,
                        f"grid-only int8, {len(index.grid_buckets)} buckets, device refine, {shape}")
                del index
                gc.collect()
                torch.cuda.empty_cache()
            if args.staged:
                index = DeviceIndex.load(work)
                params = SearchParameters(
                    approx_score="cells", n_ivf_probe=8, prune_keep=args.keep,
                    **chip_smoke.STAGED_COMMON,
                )
                profile(passes_of(index, params), args.passes,
                        f"staged cells nprobe 8 keep {args.keep}, {shape}")
        else:
            doclens = chip_smoke.make_doclens()
            tokens, topics = chip_smoke.make_corpus(doclens, device)
            create_index_from_device(tokens, doclens, work, IndexConfig(nbits=4, seed=42))
            del tokens
            index = DeviceIndex.load(work).with_token_grid(dtype=args.dtype)
            queries = chip_smoke.make_queries(topics)
            params = SearchParameters(top_k=10, stage1_precision="default")
            profile(lambda: search_batch(index, queries, params), args.passes,
                    f"pinned {args.dtype} grid, 320 queries a pass")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
