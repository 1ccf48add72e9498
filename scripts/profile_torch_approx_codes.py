"""Build, check and time staged stage 3b's kernel (csrc/approx_codes.cu)
beside the eager loop it replaced, on one NVIDIA GPU, without building an
index.

    python3 scripts/profile_torch_approx_codes.py [--reps 20] [--eager-reps 3]

Makes the tensors of an index shaped as LoTTE Lifestyle's
(scripts/profile_torch_union_grid.py's: 119,461 docs of 100-220 tokens,
K 65,536; random codes: the time depends on the shapes and the doc lengths,
not on the values) and the stage-3b inputs of the LoTTE staged cell's batch:
64 queries of 32 tokens, a [Q, Tq, K] f32 table of unit-vector dot products,
a pool of 4,096 distinct random docs a query, Td 224. Prints what ptxas
reports, checks the kernel against the eager loop on the table in f64 as
chip_smoke.py does (`approx_codes_gap`: within 1e-6, its zeros exact; raises
otherwise), then
prints one JSON line: the kernel's ms alone and with the table's transpose,
the eager loop's ms (CUDA events), the bytes the kernel must move
(chip_smoke.py's `approx_codes_bytes`) and their time at 3.35 TB/s, the
table rows it looks up, and the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from nextplaid_tpu_torch.index import search as S  # noqa: E402
from nextplaid_tpu_torch.ops import approx_codes as A  # noqa: E402
from nextplaid_tpu_torch.ops.maxsim_kernel import BUILD_DIR, build_tag  # noqa: E402
from chip_smoke import approx_codes_bytes, approx_codes_gap  # noqa: E402
from profile_torch_union_grid import DIM, DOCS, HBM_BYTES_S, K, TD, lotte_index, time_ms  # noqa: E402

Q, TQ, POOL = 64, 32, 4096


def stage3b_inputs(device, seed=2):
    """The table (unit queries against the index's unit centroids, the
    padded query tokens' rows -inf), the mask and the pool."""
    gen = torch.Generator(device=device).manual_seed(seed)
    queries = torch.nn.functional.normalize(torch.randn(Q, TQ, DIM, generator=gen, device=device),
                                            dim=-1)
    qmask = torch.ones(Q, TQ, dtype=torch.bool, device=device)
    qmask[::7, 28:] = False  # some queries shorter than the padded 32
    return queries, qmask, gen


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--eager-reps", type=int, default=3)
    args = ap.parse_args()
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    A._library()
    print((BUILD_DIR / f"approx_codes-{build_tag(A.SOURCE)}.log").read_text())
    index = lotte_index(device)
    queries, qmask, gen = stage3b_inputs(device)
    s_masked = (queries.reshape(-1, DIM) @ index.centroids.T).view(Q, TQ, K)
    s_masked = s_masked.masked_fill(~qmask[:, :, None], float("-inf"))
    ids = torch.stack([torch.randperm(DOCS, generator=gen, device=device)[:POOL]
                       for _ in range(Q)])
    ids[:, -16:] = DOCS  # the pipeline's sentinel
    shapes = types.SimpleNamespace(doc_token_cap=TD)
    run = (index, s_masked, qmask, ids, shapes)

    got = S._approx_codes_scores(*run)
    want = S._approx_codes_scores_eager(index, s_masked.double(), qmask, ids, shapes)
    max_abs, max_rel = approx_codes_gap(got, want, "approx_codes")
    check = {"max_abs": max_abs, "max_rel": max_rel,
             "equal_share": float((got == want).double().mean())}

    s_t = s_masked.transpose(1, 2).contiguous()
    kargs = (s_t, qmask, ids, index.doclens, index.doc_offsets, index.codes,
             index.num_documents, TD)
    kernel_ms = time_ms(lambda: A.approx_codes(*kargs), args.reps)
    stage_ms = time_ms(lambda: S._approx_codes_scores(*run), args.reps)
    eager_ms = time_ms(lambda: S._approx_codes_scores_eager(*run), args.eager_reps)
    moved, live = approx_codes_bytes(index, ids, K, TQ, TD)
    bound_ms = moved / HBM_BYTES_S * 1e3
    print(json.dumps({
        "card": card, "queries": Q, "tq": TQ, "pool": POOL, "k": K, "td": TD,
        "live_tokens": live, "row_bytes": live * TQ * 4, "check": check,
        "kernel_ms": round(kernel_ms, 4), "stage_ms": round(stage_ms, 4),
        "eager_ms": round(eager_ms, 3), "bytes": moved, "bound_ms": round(bound_ms, 4),
        "kernel_share_of_bound": round(bound_ms / kernel_ms, 4),
    }))


if __name__ == "__main__":
    main()
