"""The MaxSim variant sweep: one CUDA kernel family and its plain PyTorch
version.

csrc/maxsim_variants.cu replaces the Pallas variants of
`scripts/profile_kernel_variants.py` (`build(...)` over `kernel_iota`,
`kernel_addmask`, `kernel_addflat`, `kernel_iota_scratch`,
`kernel_addflat_fold`, `kernel_dotsonly`): the bf16 MaxSim of
`ops.maxsim_kernel` with a DOC-MAJOR output [ND, Q], as instances of the
served kernels' wgmma/TMA template (csrc/maxsim_wgmma.cuh), swept over
  - the mask input: `mask="lens"` (doclens [ND] or [ND, 1] int32, compared
    with the row index; a doc's walk stops at its length) or
    `mask="additive"` (an f32 mask of 0 / -1e30 per token row, [ND, Td] or
    flat [ND*Td, 1]: one row-major layout serves both shapes of the Pallas
    script, whose difference is a TPU lane/sublane matter; every row of
    every doc is walked, since the mask need not be a prefix);
  - the geometry `(docs per thread block, grid rows a ring stage holds)`:
    1..64 docs, 64 or 128 rows (one or two m64 products between two
    mbarrier waits), the card's counterpart of the script's `dblk`/`sub`;
  - the row reduction: `reduce="registers"` (per-doc max kept on the wgmma
    accumulator's layout, folded by shuffles: the served fold) or
    `"shared"` (every accumulator tile staged in shared memory and scanned
    by column there), the counterparts of concatenate / scratch / fold;
  - `dots_only=True`, the probe: the same loads and tensor-core products
    with a sum in one accumulator where the others take the max. Wrong by
    design, as `kernel_dotsonly`: out[n, q] is the sum, over every token row
    of the `geometry[0]` docs of n's block and every token of query q, of
    the products; the mask input is not read.
N, the warpgroups and the ring's depth come from `plan_variant`
(`ops.maxsim_kernel`); `variant_plan` gives a call's plan.

Layout contract: queries_flat [Q*Tq, d] bf16 with zero rows for padded query
tokens, grid [ND, Td, d] bf16. Output [ND, Q] f32. For every variant but
the probe, with a mask that marks rows at or beyond each doc's length, the
result equals `maxsim_grid_scores_reference(...).T`: empty docs score 0.

`maxsim_variant_scores` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors; a failed build or launch raises. The library is
compiled with nvcc at first use, as `ops.maxsim_kernel` builds its own.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nextplaid_tpu_torch.ops.maxsim_kernel import (
    MAX_DIM,
    MAX_DOCS_PER_BLOCK,
    MAX_TQ,
    NEG,
    SOURCE_VARIANTS,
    LaunchPlan,
    build_library,
    load_once,
    maxsim_grid_scores_reference,
    pad_bf16_inputs,
    plan_variant,
)

MASKS = {"lens": 0, "additive": 1}
REDUCES = {"registers": 0, "shared": 1}
ROWS = (64, 128)  # grid rows a ring stage holds
_DOTS = 2  # the kernel's mask code of the probe


@load_once
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE_VARIANTS)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_variants_scores.argtypes = [p, p, p, p] + [i] * 13 + [p]
    lib.maxsim_variants_scores.restype = i
    lib.maxsim_variants_smem_bytes.argtypes = [i] * 7
    lib.maxsim_variants_smem_bytes.restype = i
    lib.maxsim_variants_error_string.argtypes = [i]
    lib.maxsim_variants_error_string.restype = ctypes.c_char_p
    return lib


def _check_variant(mask: str, geometry: Tuple[int, int], reduce: str) -> None:
    if mask not in MASKS:
        raise ValueError(f"mask must be one of {sorted(MASKS)}, got {mask!r}")
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {sorted(REDUCES)}, got {reduce!r}")
    dpb, rows = geometry
    if not 1 <= dpb <= MAX_DOCS_PER_BLOCK or rows not in ROWS:
        raise ValueError(
            f"geometry (docs per block, rows a stage) must be "
            f"(1..{MAX_DOCS_PER_BLOCK}, one of {ROWS}), got {geometry!r}"
        )


def variant_plan(q_n: int, tq: int, d: int, *, mask: str = "lens",
                 geometry: Tuple[int, int] = (16, 64), reduce: str = "registers",
                 dots_only: bool = False) -> LaunchPlan:
    """The launch plan of one variant for `q_n` queries of `tq` tokens at
    feature width `d` (padded, as the wrapper pads it, to whole 128-byte
    panels)."""
    _check_variant(mask, geometry, reduce)
    d_k = -(-d // 64) * 64
    return plan_variant(
        q_n, tq, d_k * 2, geometry[0], geometry[1],
        additive=not dots_only and mask == "additive",
        scratch=not dots_only and reduce == "shared",
    )


def maxsim_variant_scores_reference(
    queries_flat: torch.Tensor,
    grid: torch.Tensor,
    mask_or_lens: torch.Tensor,
    tq: int,
    *,
    mask: str = "lens",
    geometry: Tuple[int, int] = (16, 64),
    reduce: str = "registers",
    dots_only: bool = False,
    block_bytes: int = 256 << 20,
) -> torch.Tensor:
    """Plain PyTorch version of every variant: [ND, Q] f32, exact bf16
    products summed in f32, tiled over docs so the [tile*Td, Q*Tq] f32
    product stays under `block_bytes`. `reduce` and the rows of `geometry`
    change how the kernel works, not what it computes; the probe's sums run
    over blocks of `geometry[0]` docs."""
    _check_variant(mask, geometry, reduce)
    qf, d = queries_flat.shape
    nd, td, _ = grid.shape
    q_n = qf // tq
    if not dots_only and mask == "lens":
        return maxsim_grid_scores_reference(
            queries_flat, grid, mask_or_lens.reshape(-1), tq, block_bytes
        ).T.contiguous()
    q = queries_flat.float()
    out = torch.empty(nd, q_n, dtype=torch.float32, device=grid.device)
    dpb = geometry[0]
    tile = max(1, block_bytes // max(qf * td * 4, 1))
    if dots_only:
        tile = max(dpb, tile // dpb * dpb)  # whole blocks of dpb docs
    else:
        addmask = mask_or_lens.reshape(nd, td).float().to(grid.device)
    for s in range(0, nd, tile):
        g = grid[s : s + tile].float()
        n = g.shape[0]
        sim = (g.reshape(n * td, d) @ q.T).view(n, td, qf)
        if dots_only:
            per_doc = sim.sum(dim=1).view(n, q_n, tq).sum(dim=2)  # [n, Q]
            blocks = -(-n // dpb)
            per_block = F.pad(per_doc, (0, 0, 0, blocks * dpb - n)).view(
                blocks, dpb, q_n
            ).sum(dim=1)
            out[s : s + n] = per_block.repeat_interleave(dpb, dim=0)[:n]
        else:
            m = (sim + addmask[s : s + n, :, None]).amax(dim=1)  # [n, Qf]
            m = torch.where(m > NEG / 2, m, torch.zeros_like(m))
            out[s : s + n] = m.view(n, q_n, tq).sum(dim=2)
    return out


def _check_cuda_inputs(queries_flat, grid, mask_or_lens, tq, mask, dots_only) -> None:
    dev = grid.device
    tensors = [
        ("queries_flat", queries_flat, torch.bfloat16),
        ("grid", grid, torch.bfloat16),
    ]
    if not dots_only:
        tensors.append(
            ("mask_or_lens", mask_or_lens,
             torch.int32 if mask == "lens" else torch.float32)
        )
    for name, t, dtype in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grid on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    qf, d = queries_flat.shape
    nd, td, dg = grid.shape
    if dg != d or d % 16 or d > MAX_DIM:
        raise ValueError(
            f"dim {d} (grid {dg}) must match and be a multiple of 16 up to {MAX_DIM}"
        )
    if tq <= 0 or qf % tq or tq > MAX_TQ:
        raise ValueError(f"tq={tq} must divide {qf} rows and be <= {MAX_TQ}")
    if not dots_only:
        want = nd if mask == "lens" else nd * td
        if mask_or_lens.numel() != want:
            raise ValueError(
                f"{mask} mask holds {mask_or_lens.numel()} values, expected {want}"
            )


def _launch(queries_flat, grid, mask_or_lens, tq, mask, geometry, reduce, dots_only):
    qf, d = queries_flat.shape
    nd, td, _ = grid.shape
    q_n = qf // tq
    out = torch.empty(nd, q_n, dtype=torch.float32, device=grid.device)
    if q_n == 0 or nd == 0:
        return out
    plan = variant_plan(q_n, tq, d, mask=mask, geometry=geometry, reduce=reduce,
                        dots_only=dots_only)
    queries_flat, grid = pad_bf16_inputs(queries_flat, grid)
    mask_code = _DOTS if dots_only else MASKS[mask]
    side, mask_cols = None, td
    if mask_code == MASKS["lens"]:
        side = mask_or_lens.data_ptr()
    elif mask_code == MASKS["additive"]:
        # TMA reads the mask in rows of a multiple of 16 bytes: pad each row
        # to a multiple of 4 values with the mask value itself.
        mask_cols = -(-td // 4) * 4
        addmask = mask_or_lens.reshape(nd, td)
        if mask_cols != td:
            addmask = F.pad(addmask, (0, mask_cols - td), value=NEG)
        side = addmask.data_ptr()
    lib = _library()
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxsim_variants_scores(
            queries_flat.data_ptr(), grid.data_ptr(), side, out.data_ptr(),
            q_n, tq, nd, td, mask_cols, grid.shape[2], mask_code, REDUCES[reduce],
            plan.rows // 64, plan.n, plan.n_wg, plan.dpb, plan.stages, stream,
        )
    if err != 0:
        msg = lib.maxsim_variants_error_string(err).decode()
        raise RuntimeError(f"maxsim_variants kernel launch failed: {msg} ({err})")
    maxsim_variant_scores.launches += 1
    return out


def maxsim_variant_scores(
    queries_flat: torch.Tensor,
    grid: torch.Tensor,
    mask_or_lens: torch.Tensor,
    tq: int,
    *,
    mask: str = "lens",
    geometry: Tuple[int, int] = (16, 64),
    reduce: str = "registers",
    dots_only: bool = False,
) -> torch.Tensor:
    """One variant of the doc-major bf16 MaxSim, [ND, Q] f32 (see the module
    docstring for the axes).

    CPU tensors go through `maxsim_variant_scores_reference`; CUDA tensors
    launch the CUDA kernel (or raise)."""
    _check_variant(mask, geometry, reduce)
    if not grid.is_cuda:
        return maxsim_variant_scores_reference(
            queries_flat, grid, mask_or_lens, tq, mask=mask, geometry=geometry,
            reduce=reduce, dots_only=dots_only,
        )
    _check_cuda_inputs(queries_flat, grid, mask_or_lens, tq, mask, dots_only)
    return _launch(queries_flat, grid, mask_or_lens, tq, mask, tuple(geometry), reduce,
                   dots_only)


maxsim_variant_scores.launches = 0  # kernel launches since the last reset


# ---------------------------------------------------------------------------
# The sweep: its variants, its inputs and its matmul-only yardstick
# ---------------------------------------------------------------------------

# (name, mask, (docs per block, rows a stage), reduce, dots_only): the docs
# per block of the Pallas sweep's list; 64 rows a stage where its entry
# multiplied 16 or 32 rows between synchronisations, 128 where 64 (and for
# one of the two 16-doc lens entries, so that the 14 stay distinct).
SWEEP_VARIANTS = (
    ("lens d64 r128 reg", "lens", (64, 128), "registers", False),
    ("lens d32 r64 reg", "lens", (32, 64), "registers", False),
    ("lens d16 r64 reg", "lens", (16, 64), "registers", False),
    ("lens d16 r128 reg", "lens", (16, 128), "registers", False),
    ("lens d8  r64 reg", "lens", (8, 64), "registers", False),
    ("add  d32 r64 reg", "additive", (32, 64), "registers", False),
    ("add  d16 r64 reg", "additive", (16, 64), "registers", False),
    ("add  d64 r128 reg", "additive", (64, 128), "registers", False),
    ("add  d16 r64 shm", "additive", (16, 64), "shared", False),
    ("add  d8  r64 shm", "additive", (8, 64), "shared", False),
    ("lens d32 r64 shm", "lens", (32, 64), "shared", False),
    ("lens d64 r128 shm", "lens", (64, 128), "shared", False),
    ("dots d16 r64", "lens", (16, 64), "registers", True),
    ("dots d64 r128", "lens", (64, 128), "registers", True),
)
SWEEP_SHAPE = dict(nd=5184, td=384, d=128, tq=32)  # the Pallas sweep's


def sweep_inputs(device, num_queries: int = 64, nd: int = 5184, td: int = 384,
                 d: int = 128, tq: int = 32, seed: int = 0):
    """The sweep's inputs: lengths min(64, td/4)..td-1 from numpy `seed` with every
    seventh doc empty (as the Pallas script), a normal bf16 grid with rows at
    or beyond each length zeroed and normal bf16 queries made on `device`
    from a torch.Generator. Returns (queries_flat [Q*tq, d], grid [nd, td, d],
    lens [nd] int32, addmask [nd, td] f32 of 0 / -1e30)."""
    lens_np = np.random.default_rng(seed).integers(
        min(64, max(td // 4, 1)), td, size=nd
    ).astype(np.int32)
    lens_np[::7] = 0
    lens = torch.from_numpy(lens_np).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    valid = torch.arange(td, device=device)[None, :] < lens[:, None]
    grid = torch.empty((nd, td, d), dtype=torch.bfloat16, device=device)
    step = max(1, (256 << 20) // (td * d * 4))
    for s in range(0, nd, step):
        n = min(step, nd - s)
        g = torch.randn((n, td, d), generator=gen, device=device)
        grid[s : s + n] = torch.where(valid[s : s + n, :, None], g, 0.0).to(torch.bfloat16)
    queries = torch.randn(
        (num_queries * tq, d), generator=gen, device=device
    ).to(torch.bfloat16)
    addmask = torch.where(valid, 0.0, NEG).to(torch.float32).contiguous()
    return queries, grid, lens, addmask


def one_big_dot_floor(
    queries_flat: torch.Tensor, grid: torch.Tensor, block_bytes: int = 512 << 20
) -> torch.Tensor:
    """The sweep's matmul-only yardstick (`floor_fn` of the Pallas script):
    the same contraction with no mask, max or epilogue, as bf16
    `torch.matmul` products summed per doc over all its token rows and all
    query tokens, [ND] f32. Tiled over docs so the [ND*Td, Q*Tq] product is
    never whole in memory. It times what a library's tensor-core product
    takes for the kernels' contraction; nothing in the package calls it."""
    nd, td, d = grid.shape
    qf = queries_flat.shape[0]
    qt = queries_flat.T.contiguous()
    out = torch.empty(nd, dtype=torch.float32, device=grid.device)
    tile = max(1, block_bytes // max(td * qf * 2, 1))
    for s in range(0, nd, tile):
        g = grid[s : s + tile]
        n = g.shape[0]
        prod = torch.matmul(g.reshape(n * td, d), qt)  # [n*Td, Qf] bf16
        out[s : s + n] = prod.view(n, td * qf).sum(dim=1, dtype=torch.float32)
    return out
