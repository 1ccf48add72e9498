"""Fused MaxSim over the pinned token grids: CUDA kernels and their plain
PyTorch versions.

Two kernels, each replacing a Pallas kernel of
`nextplaid_tpu.ops.maxsim_kernel`:
  - csrc/maxsim_bf16.cu: `maxsim_grid_scores` / `_kernel` (bf16 grid);
  - csrc/maxsim_int8.cu: `maxsim_grid_scores_int8i` / `_kernel_int8i`
    (int8 grid with per-token dequant scales).
Both include csrc/maxsim_wgmma.cuh, the one design they share: wgmma
products on 64-row doc tiles, fed by a ring of TMA loads that mbarriers
hand from one producer thread to two consumer warpgroups, each with its own
block of query-token columns, the per-doc max taken in registers. Both are
bound by operations on an H100 at the main paths' shapes (one query against
the int8 grid by bytes); each source's note says what the design does about
that. `plan_launch` picks, in Python, what the launch needs: the columns a
warpgroup owns (from the columns the call really has), one or two
warpgroups, the docs a block walks and the ring's depth within the shared
memory a block may use.
This module also builds the third source, csrc/maxsim_variants.cu (the
variant sweep's kernel family on the same template; its wrapper is
`ops.maxsim_variants`), and plans its launches (`plan_variant`).

bf16 layout contract (as the JAX package's, with doclens flat):
  queries_flat [Q*Tq, d] bf16, padded query tokens are zero rows, so they
               contribute exactly 0 (the kernel takes no query mask);
  grid_tokens  [ND, Td, d] bf16, token rows at or beyond a doc's length zero;
  doclens      [ND] int32 (0 for padding docs).
Output [Q, ND] f32: scores[q, n] = sum_t max_{j < doclens[n]} <q_t, grid[n, j]>,
bf16 products summed in f32; a doc with doclens == 0 scores 0.

int8 layout contract (doc-major, unlike the JAX package's token-interleaved
[NB, d, 128*Td] groups; `container.int8_grid_from_interleaved` converts):
  queries_i8 [Q*Tq, d] int8 and qscales [Q*Tq] f32 (0 for padded tokens),
             from `index.exact.quantize_queries_int8`;
  grid_i8    [ND, Td, d] int8;
  scales     [ND, Td] bf16 per-token dequant scales, 0 for invalid tokens
             (scale 0 is the mask: no doclens input).
Output [Q, ND] f32: scores[q, n] = sum_t qscales[q*Tq+t] * m_t with
m_t = max over valid j of float(<q_i8_t, grid_i8[n, j]>) * scales[n, j]
(int32 dots), m_t = 0 for a doc with no valid token.

`maxsim_grid_scores` and `maxsim_grid_scores_int8i` run the plain version
for CPU tensors and launch their kernel for CUDA tensors; a failed build or
launch raises. Each kernel's library is compiled with nvcc at first use into
build/nextplaid_tpu_torch/ and loaded with ctypes; a library is rebuilt when
its source, a header it includes or the flags change. Builds and loads are
thread-safe: a server's first searches arrive on several executor threads at
once, and one source is compiled once (`load_kernels` builds and loads the
served kernels before a server takes requests).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "maxsim_bf16.cu"
SOURCE_INT8 = CSRC / "maxsim_int8.cu"
SOURCE_VARIANTS = CSRC / "maxsim_variants.cu"  # wrapper: ops/maxsim_variants.py
SOURCES = (SOURCE, SOURCE_INT8, SOURCE_VARIANTS)
# What a server launches: both MaxSim kernels, the staged route's union
# grid (wrapper: ops/union_grid.py) and its stage-3b scores (wrapper:
# ops/approx_codes.py).
SERVED_SOURCES = (SOURCE, SOURCE_INT8, CSRC / "union_grid.cu", CSRC / "approx_codes.cu")
HEADER_WGMMA = CSRC / "maxsim_wgmma.cuh"
# Headers each source includes: their bytes are part of its build hash.
HEADERS = {src: (HEADER_WGMMA,) for src in SOURCES}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nextplaid_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_TQ = 256
MAX_DIM = 256
MAX_DOCS = 65535 * 8  # grid rows of one bf16 launch; callers chunk above it
BF16_DIM_STEP = 64  # the bf16 kernel's dims are its multiples; others are padded
INT8_DIMS = (128, 256)  # the int8 kernel's dims; others are padded
# The launch plan's constants, as in csrc/maxsim_wgmma.cuh.
WGMMA_COLS = (32, 64, 128, 256)  # query-token columns of one warpgroup
CONSUMERS = 2  # consumer warpgroups of a block
TILE_ROWS = 64
PANEL_BYTES = 128
MAX_STAGES = 8
MAX_DOCS_PER_BLOCK = 64
SCRATCH_PAD = 8  # f32 past N in a row of the shared-memory reduction's scratch
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
SM_COUNT = 132
NEG = -1e30  # the int8 kernels' mask value (the Pallas kernel's NEG)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_tag(source: Path) -> str:
    """Content hash of a source, the headers it includes and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in HEADERS.get(source, ()):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


# Guards the launch counts: a server launches from several executor threads.
_COUNT_LOCK = threading.Lock()
# One lock a source: threads asking for one library wait for one nvcc, while
# build_all's threads still compile different sources at once.
_BUILD_LOCKS: Dict[Path, threading.Lock] = {src: threading.Lock() for src in SOURCES}


def build_library(source: Path = SOURCE) -> Path:
    """Compile one kernel source into a shared library (once per source,
    headers and flags; the build log beside it holds ptxas' register and
    shared memory report). Returns the library's path."""
    tag = build_tag(source)
    lib = BUILD_DIR / f"{source.stem}-{tag}.so"
    with _BUILD_LOCKS.setdefault(source, threading.Lock()):
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Another process may build the same library into this directory:
        # each writer has its own temporary name, and the rename is atomic.
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name} with exit code "
                f"{proc.returncode}:\n{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stderr)
        os.replace(tmp, lib)
        return lib


def build_all() -> Dict[str, Path]:
    """Compile every kernel source at once, one nvcc process each. Returns
    {source stem: library path}."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(build_library, SOURCES))
    return {src.stem: lib for src, lib in zip(SOURCES, libs)}


def load_once(loader):
    """Memoize a library loader: concurrent first calls run it once."""
    lock = threading.Lock()
    loaded = []

    @functools.wraps(loader)
    def wrapper():
        if not loaded:
            with lock:
                if not loaded:
                    loaded.append(loader())
        return loaded[0]

    return wrapper


@load_once
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_bf16_scores.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.maxsim_bf16_scores.restype = i
    lib.maxsim_bf16_smem_bytes.argtypes = [i, i, i, i]
    lib.maxsim_bf16_smem_bytes.restype = i
    lib.maxsim_bf16_error_string.argtypes = [i]
    lib.maxsim_bf16_error_string.restype = ctypes.c_char_p
    return lib


@load_once
def _library_int8() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE_INT8)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_int8_scores.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.maxsim_int8_scores.restype = i
    lib.maxsim_int8_smem_bytes.argtypes = [i, i, i, i]
    lib.maxsim_int8_smem_bytes.restype = i
    lib.maxsim_int8_error_string.argtypes = [i]
    lib.maxsim_int8_error_string.restype = ctypes.c_char_p
    return lib


def build_served() -> Dict[str, Path]:
    """Compile the served kernels (SERVED_SOURCES), one nvcc each, started
    together, without loading them (an image build runs this without a
    card). Returns {source stem: library path}."""
    with ThreadPoolExecutor(len(SERVED_SOURCES)) as pool:
        libs = list(pool.map(build_library, SERVED_SOURCES))
    return {src.stem: lib for src, lib in zip(SERVED_SOURCES, libs)}


def load_kernels() -> None:
    """Build (`build_served`) and load the served kernels. A server on a
    card calls this before it takes requests, so that no request, staged
    ones included, waits for nvcc."""
    from nextplaid_tpu_torch.ops import approx_codes, union_grid

    build_served()
    _library()
    _library_int8()
    union_grid._library()
    approx_codes._library()


@dataclass(frozen=True)
class LaunchPlan:
    """What one launch of a MaxSim kernel needs beyond its tensors."""

    n: int  # query-token columns a consumer warpgroup owns (a wgmma N)
    n_wg: int  # warpgroups (query groups) a block takes: 1 or 2
    qpw: int  # whole queries a warpgroup owns: n // tq
    dpb: int  # docs a block walks
    stages: int  # stages in the shared-memory ring
    panels: int  # 128-byte panels of a row
    smem: int  # dynamic shared memory of a block, bytes
    rows: int = TILE_ROWS  # grid rows a ring stage holds (64 or 128)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(n: int, n_wg: int, panels: int, stages: int, scales: bool, sub: int = 1,
               side: int = 0, scratch: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/maxsim_wgmma.cuh's
    `smem_layout`): the query columns, the tile ring of `sub` tiles a stage
    (with a tile's side input: 64 bf16 scales for int8, `side` bytes
    otherwise, 256 for the additive mask's f32), the shared-memory row
    reduction's `scratch` of [n_wg][64][n + 8] f32, the per-warp and
    per-column maxima (and the query scales for int8), the docs' lengths, the
    mbarriers, 1,024 bytes to align."""
    total = n_wg * panels * n * PANEL_BYTES
    total += stages * sub * panels * TILE_ROWS * PANEL_BYTES
    total += stages * sub * (TILE_ROWS * 2 if scales else side)
    total += n_wg * TILE_ROWS * (n + SCRATCH_PAD) * 4 if scratch else 0
    total += CONSUMERS * 4 * n * 4 + CONSUMERS * n * 4
    total += CONSUMERS * n * 4 if scales else 0
    total += MAX_DOCS_PER_BLOCK * 4 + (2 * MAX_STAGES + 1) * 8
    return total + 1024


def _pick_shape(q_n: int, tq: int, row_bytes: int, stage_bytes: int, fixed_bytes):
    """(n, n_wg, stages) of a launch: of the shapes whose ring has at least 2
    stages of `stage_bytes` beside `fixed_bytes(n, n_wg)`, the narrowest
    that holds every query, two warpgroups before one; if none holds them
    all, the one that holds the most. Shapes of up to 64 columns keep to half
    an SM's shared memory, so that two blocks share it."""
    if row_bytes <= 0 or row_bytes % PANEL_BYTES:
        raise ValueError(f"row bytes {row_bytes} must be a multiple of {PANEL_BYTES}")
    if not 0 < tq <= WGMMA_COLS[-1]:
        raise ValueError(f"tq={tq} must be in 1..{WGMMA_COLS[-1]}")
    shapes = []
    for n in WGMMA_COLS:
        for n_wg in (2, 1):
            # The narrow instances are built for two blocks an SM.
            limit = SMEM_LIMIT if n > 64 else SMEM_LIMIT // 2 - 1024
            stages = min(MAX_STAGES, (limit - fixed_bytes(n, n_wg)) // stage_bytes)
            if n >= tq and stages >= 2:
                shapes.append((n, n_wg, stages))
    if not shapes:
        raise ValueError(f"no kernel shape fits tq={tq} at {row_bytes} bytes a row")
    holding = [s for s in shapes if s[1] * (s[0] // tq) >= q_n]
    if holding:
        return min(holding, key=lambda s: (s[0] * s[1], -s[1]))
    return max(shapes, key=lambda s: (s[1] * (s[0] // tq), s[1], s[2]))


def plan_launch(q_n: int, tq: int, nd: int, row_bytes: int, scales: bool) -> LaunchPlan:
    """Pick the kernel instance and block shape for `q_n` queries of `tq`
    tokens against `nd` grid rows of `row_bytes` bytes (a multiple of 128).

    A warpgroup owns n >= tq columns holding n // tq whole queries, a block
    one or two such groups, picked by `_pick_shape` (one query does not pay
    for 512 columns). The docs a block walks start at 16 and halve until the
    launch has four blocks an SM or one doc a block."""
    panels = row_bytes // PANEL_BYTES
    stage = panels * TILE_ROWS * PANEL_BYTES + (TILE_ROWS * 2 if scales else 0)
    n, n_wg, stages = _pick_shape(
        q_n, tq, row_bytes, stage, lambda n, n_wg: smem_bytes(n, n_wg, panels, 0, scales))
    qpw = n // tq
    n_qblocks = _ceil_div(_ceil_div(q_n, qpw), n_wg)
    dpb = 16
    while dpb > 1 and n_qblocks * _ceil_div(nd, dpb) < 4 * SM_COUNT:
        dpb //= 2
    return LaunchPlan(n=n, n_wg=n_wg, qpw=qpw, dpb=dpb, stages=stages, panels=panels,
                      smem=smem_bytes(n, n_wg, panels, stages, scales))


def plan_variant(q_n: int, tq: int, row_bytes: int, dpb: int, rows: int = TILE_ROWS,
                 additive: bool = False, scratch: bool = False) -> LaunchPlan:
    """The plan of one launch of the bf16 variant family
    (csrc/maxsim_variants.cu): N, warpgroups and ring depth chosen as
    `plan_launch` chooses them, for ring stages of `rows` grid rows (64 or
    128), each 64-row tile with its 64 f32 mask values if `additive`, and,
    with `scratch`, the shared-memory reduction's staging (at N 256 it fits
    only one warpgroup, so the plan takes N 128 with two where both hold the
    same queries). The docs a block walks are the caller's `dpb`, 1..64."""
    if rows not in (TILE_ROWS, 2 * TILE_ROWS):
        raise ValueError(f"rows a stage must be {TILE_ROWS} or {2 * TILE_ROWS}, got {rows}")
    if not 1 <= dpb <= MAX_DOCS_PER_BLOCK:
        raise ValueError(f"docs a block must be in 1..{MAX_DOCS_PER_BLOCK}, got {dpb}")
    panels = row_bytes // PANEL_BYTES
    sub = rows // TILE_ROWS
    side = TILE_ROWS * 4 if additive else 0
    stage = sub * (panels * TILE_ROWS * PANEL_BYTES + side)
    n, n_wg, stages = _pick_shape(
        q_n, tq, row_bytes, stage,
        lambda n, n_wg: smem_bytes(n, n_wg, panels, 0, False, sub, side, scratch))
    return LaunchPlan(n=n, n_wg=n_wg, qpw=n // tq, dpb=dpb, stages=stages, panels=panels,
                      smem=smem_bytes(n, n_wg, panels, stages, False, sub, side, scratch),
                      rows=rows)


def maxsim_grid_scores_reference(
    queries_flat: torch.Tensor,
    grid_tokens: torch.Tensor,
    doclens: torch.Tensor,
    tq: int,
    block_bytes: int = 256 << 20,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: exact bf16 products summed in
    f32, tiled over docs so the [Q*Tq, tile, Td] f32 similarity block stays
    under `block_bytes`."""
    qf, d = queries_flat.shape
    nd, td, _ = grid_tokens.shape
    q_n = qf // tq
    q = queries_flat.float()
    lens = doclens.reshape(-1).to(grid_tokens.device)
    t_ar = torch.arange(td, device=grid_tokens.device)
    out = torch.empty(q_n, nd, dtype=torch.float32, device=grid_tokens.device)
    tile = max(1, block_bytes // max(qf * td * 4, 1))
    for s in range(0, nd, tile):
        g = grid_tokens[s : s + tile].float()
        n = g.shape[0]
        sim = (q @ g.reshape(n * td, d).T).view(qf, n, td)
        valid = t_ar[None, :] < lens[s : s + n, None]  # [n, Td]
        sim = sim.masked_fill(~valid[None], float("-inf"))
        per_tok = sim.amax(dim=-1)  # [Qf, n]
        per_tok = torch.where(
            lens[s : s + n][None, :] > 0, per_tok, torch.zeros_like(per_tok)
        )
        out[:, s : s + n] = per_tok.view(q_n, tq, n).sum(dim=1)
    return out


def _check_cuda_inputs(queries_flat, grid_tokens, doclens, tq) -> None:
    dev = queries_flat.device
    for name, t, dtype in (
        ("queries_flat", queries_flat, torch.bfloat16),
        ("grid_tokens", grid_tokens, torch.bfloat16),
        ("doclens", doclens, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    qf, d = queries_flat.shape
    nd, td, dg = grid_tokens.shape
    if dg != d or d % 16 or d > MAX_DIM:
        raise ValueError(
            f"dim {d} (grid {dg}) must match and be a multiple of 16 "
            f"up to {MAX_DIM}"
        )
    if tq <= 0 or qf % tq or tq > MAX_TQ:
        raise ValueError(f"tq={tq} must divide {qf} rows and be <= {MAX_TQ}")
    if doclens.shape != (nd,):
        raise ValueError(f"doclens shape {tuple(doclens.shape)} != ({nd},)")
    if nd > MAX_DOCS:
        raise ValueError(f"{nd} grid rows exceed the kernel's {MAX_DOCS}")


def pad_bf16_inputs(queries_flat, grid_tokens):
    """The bf16 kernel takes d in multiples of 64 (whole 128-byte panels):
    pad other d with zero features, which add exactly 0 to every product.
    Returns (queries, grid), the inputs themselves when nothing is padded."""
    d = grid_tokens.shape[2]
    d_k = -(-d // BF16_DIM_STEP) * BF16_DIM_STEP
    if d_k == d:
        return queries_flat, grid_tokens
    return F.pad(queries_flat, (0, d_k - d)), F.pad(grid_tokens, (0, d_k - d))


def _launch(queries_flat, grid_tokens, doclens, tq) -> torch.Tensor:
    qf, d = queries_flat.shape
    nd, td, _ = grid_tokens.shape
    q_n = qf // tq
    out = torch.empty(q_n, nd, dtype=torch.float32, device=grid_tokens.device)
    if q_n == 0 or nd == 0:
        return out
    queries_flat, grid_tokens = pad_bf16_inputs(queries_flat, grid_tokens)
    d_k = grid_tokens.shape[2]
    plan = plan_launch(q_n, tq, nd, d_k * 2, scales=False)
    lib = _library()
    with torch.cuda.device(grid_tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxsim_bf16_scores(
            queries_flat.data_ptr(), grid_tokens.data_ptr(),
            doclens.data_ptr(), out.data_ptr(),
            q_n, tq, nd, td, d_k, plan.n, plan.n_wg, plan.dpb, plan.stages, stream,
        )
    if err != 0:
        msg = lib.maxsim_bf16_error_string(err).decode()
        raise RuntimeError(f"maxsim_bf16 kernel launch failed: {msg} ({err})")
    with _COUNT_LOCK:
        maxsim_grid_scores.launches += 1
    return out


def maxsim_grid_scores(
    queries_flat: torch.Tensor,
    grid_tokens: torch.Tensor,
    doclens: torch.Tensor,
    tq: int,
) -> torch.Tensor:
    """Exhaustive MaxSim scores [Q, ND] f32 over the bf16 token grid.

    CPU tensors go through `maxsim_grid_scores_reference`; CUDA tensors
    launch the CUDA kernel (or raise)."""
    doclens = doclens.reshape(-1)
    if not grid_tokens.is_cuda:
        return maxsim_grid_scores_reference(queries_flat, grid_tokens, doclens, tq)
    _check_cuda_inputs(queries_flat, grid_tokens, doclens, tq)
    return _launch(queries_flat, grid_tokens, doclens, tq)


maxsim_grid_scores.launches = 0  # kernel launches since the last reset


# ---------------------------------------------------------------------------
# int8 grid
# ---------------------------------------------------------------------------


def maxsim_grid_scores_int8i_reference(
    queries_i8: torch.Tensor,
    qscales: torch.Tensor,
    grid_i8: torch.Tensor,
    scales: torch.Tensor,
    tq: int,
    block_bytes: int = 256 << 20,
) -> torch.Tensor:
    """Plain PyTorch version of the int8 kernel, tiled over docs so the
    [Q*Tq, tile, Td] f32 block stays under `block_bytes`.

    The int32 dot runs as an f32 matmul of int8 values: exact, since every
    partial sum is below 127^2 * d < 2^24 (d <= 1024), so each per-token
    value equals the kernel's bit for bit; only the order of the final sum
    over query tokens differs."""
    qf, d = queries_i8.shape
    nd, td, _ = grid_i8.shape
    q_n = qf // tq
    dev = grid_i8.device
    q = queries_i8.to(dev).float()
    qs = qscales.to(dev).float()
    out = torch.empty(q_n, nd, dtype=torch.float32, device=dev)
    tile = max(1, block_bytes // max(qf * td * 4, 1))
    for s in range(0, nd, tile):
        g = grid_i8[s : s + tile].float()
        n = g.shape[0]
        dots = (q @ g.reshape(n * td, d).T).view(qf, n, td)
        sc = scales[s : s + n].float()
        v = torch.where(sc[None] > 0, dots * sc[None], torch.full_like(dots, NEG))
        m = v.amax(dim=-1)  # [Qf, n]
        m = torch.where(m > NEG / 2, m, torch.zeros_like(m))
        out[:, s : s + n] = (m * qs[:, None]).view(q_n, tq, n).sum(dim=1)
    return out


def _check_cuda_inputs_int8(queries_i8, qscales, grid_i8, scales, tq) -> None:
    dev = grid_i8.device
    for name, t, dtype in (
        ("queries_i8", queries_i8, torch.int8),
        ("qscales", qscales, torch.float32),
        ("grid_i8", grid_i8, torch.int8),
        ("scales", scales, torch.bfloat16),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, grid on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    qf, d = queries_i8.shape
    nd, td, dg = grid_i8.shape
    if dg != d or d > MAX_DIM:
        raise ValueError(f"dim {d} (grid {dg}) must match and be <= {MAX_DIM}")
    if tq <= 0 or qf % tq or tq > MAX_TQ:
        raise ValueError(f"tq={tq} must divide {qf} rows and be <= {MAX_TQ}")
    if qscales.shape != (qf,):
        raise ValueError(f"qscales shape {tuple(qscales.shape)} != ({qf},)")
    if scales.shape != (nd, td):
        raise ValueError(f"scales shape {tuple(scales.shape)} != ({nd}, {td})")


def pad_int8_inputs(queries_i8, grid_i8, scales):
    """The int8 kernel takes d 128 or 256 and Td in multiples of 8 (16-byte
    rows of scales): pad with zero features and zero-scale doc tokens, which
    add exactly 0 and mask nothing real. Returns (queries, grid, scales),
    the inputs themselves when nothing is padded."""
    _, td, d = grid_i8.shape
    d_k = next(x for x in INT8_DIMS if x >= d)
    td8 = -(-td // 8) * 8
    if d_k == d and td8 == td:
        return queries_i8, grid_i8, scales
    return (F.pad(queries_i8, (0, d_k - d)), F.pad(grid_i8, (0, d_k - d, 0, td8 - td)),
            F.pad(scales, (0, td8 - td)))


def _launch_int8(queries_i8, qscales, grid_i8, scales, tq) -> torch.Tensor:
    qf, d = queries_i8.shape
    nd, td, _ = grid_i8.shape
    q_n = qf // tq
    out = torch.empty(q_n, nd, dtype=torch.float32, device=grid_i8.device)
    if q_n == 0 or nd == 0:
        return out
    queries_i8, grid_i8, scales = pad_int8_inputs(queries_i8, grid_i8, scales)
    _, td8, d_k = grid_i8.shape
    plan = plan_launch(q_n, tq, nd, d_k, scales=True)
    lib = _library_int8()
    with torch.cuda.device(grid_i8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxsim_int8_scores(
            queries_i8.data_ptr(), qscales.data_ptr(), grid_i8.data_ptr(),
            scales.data_ptr(), out.data_ptr(), q_n, tq, nd, td8, d_k,
            plan.n, plan.n_wg, plan.dpb, plan.stages, stream,
        )
    if err != 0:
        msg = lib.maxsim_int8_error_string(err).decode()
        raise RuntimeError(f"maxsim_int8 kernel launch failed: {msg} ({err})")
    with _COUNT_LOCK:
        maxsim_grid_scores_int8i.launches += 1
    return out


def maxsim_grid_scores_int8i(
    queries_i8: torch.Tensor,
    qscales: torch.Tensor,
    grid_i8: torch.Tensor,
    scales: torch.Tensor,
    tq: int,
) -> torch.Tensor:
    """Exhaustive MaxSim scores [Q, ND] f32 over the doc-major int8 grid.

    CPU tensors go through `maxsim_grid_scores_int8i_reference`; CUDA
    tensors launch the CUDA kernel (or raise)."""
    if not grid_i8.is_cuda:
        return maxsim_grid_scores_int8i_reference(
            queries_i8, qscales, grid_i8, scales, tq
        )
    _check_cuda_inputs_int8(queries_i8, qscales, grid_i8, scales, tq)
    return _launch_int8(queries_i8, qscales, grid_i8, scales, tq)


maxsim_grid_scores_int8i.launches = 0  # kernel launches since the last reset
