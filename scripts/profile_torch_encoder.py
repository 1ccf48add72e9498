"""Where the time of the ColBERT encoder goes, for nextplaid_tpu_torch on a GPU.

    python scripts/profile_torch_encoder.py [--passes 3] [--docs 1024] [--quantized]

Builds the encoder of chip_smoke.py's encoder phase (GTE-ModernColBERT-v1's
widths, random weights from seed 0, bf16; `--quantized` for the int8 mode)
and, under torch.profiler:
  1. runs `--passes` packed forwards (`ColbertModel.forward_packed`, what
     `encode_documents` runs) of one batch of 64 documents' live tokens and
     prints the device time a forward by PyTorch op (self time of each
     aten op, so a matmul's kernels count once) and by kernel;
  2. runs `encode_documents` over `--docs` of chip_smoke.py's documents and
     prints the wall time, the device's busy time and its idle share.
Prints the card's name and power limit first, then one JSON line for each.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (widths, tokenizer, documents)
from nextplaid_tpu_torch.encoder import (  # noqa: E402
    BackboneConfig,
    Colbert,
    init_random_params,
)

ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def _cut(name, n=90):
    return name if len(name) <= n else name[: n - 3] + "..."


def device_ms(prof, passes):
    """({aten op: self device ms a pass}, {kernel: device ms a pass}, busy ms)."""
    ops = {}
    for evt in prof.key_averages():
        ms = evt.self_device_time_total / 1e3 / passes
        if ms > 0 and evt.key.startswith("aten::"):
            ops[evt.key] = ops.get(evt.key, 0.0) + ms
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = _cut(evt.name)
            kernels[name] = kernels.get(name, 0.0) + evt.device_time / 1e3 / passes
    top = lambda d, n: dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])  # noqa: E731
    return top(ops, 16), top(kernels, 16), sum(kernels.values())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--docs", type=int, default=1024)
    ap.add_argument("--quantized", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_encoder: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    bcfg = BackboneConfig(**chip_smoke.GTE_WIDTHS)
    tok = chip_smoke.WhitespaceTokenizer(bcfg.vocab_size)
    enc = Colbert(config=chip_smoke.colbert_config(tok, bcfg.projection_dim),
                  backbone_config=bcfg, tokenizer=tok, params=init_random_params(bcfg, seed=0),
                  batch_size=chip_smoke.ENC_BATCH, quantized=args.quantized, device=device)
    texts = chip_smoke.make_texts(args.docs, chip_smoke.ENC_WORDS, tok.n_words)
    ids, attn, _, _ = enc._prepare(texts[: chip_smoke.ENC_BATCH], is_query=False)
    packed = chip_smoke.packed_batch(ids, attn, device)
    mode = "int8" if args.quantized else "bf16"

    def forward():
        with torch.inference_mode():
            enc.model.forward_packed(*packed)

    forward()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTS) as prof:
        t0 = time.perf_counter()
        for _ in range(args.passes):
            forward()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.passes
    ops, kernels, busy = device_ms(prof, args.passes)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": f"packed forward {mode} 64 documents, {packed[0].numel()} tokens",
        "passes": args.passes, "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_ms_by_op": ops, "device_ms_by_kernel": kernels,
    }), flush=True)

    enc.encode_documents(texts[: 2 * chip_smoke.ENC_BATCH])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTS) as prof:
        t0 = time.perf_counter()
        enc.encode_documents(texts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    _, _, busy = device_ms(prof, 1)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "path": f"encode_documents {mode}",
        "docs": args.docs, "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "docs_per_s": args.docs / (wall_ms / 1e3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
