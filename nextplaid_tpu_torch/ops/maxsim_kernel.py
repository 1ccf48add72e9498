"""Fused MaxSim over the pinned token grids: CUDA kernels and their plain
PyTorch versions.

Two kernels, each replacing a Pallas kernel of
`nextplaid_tpu.ops.maxsim_kernel`:
  - csrc/maxsim_bf16.cu: `maxsim_grid_scores` / `_kernel` (bf16 grid);
  - csrc/maxsim_int8.cu: `maxsim_grid_scores_int8i` / `_kernel_int8i`
    (int8 grid with per-token dequant scales).
This module also builds the third source, csrc/maxsim_variants.cu (the
variant sweep's kernel family; its wrapper is `ops.maxsim_variants`).
Both are compute-bound on an H100 at the main paths' shapes; each source's
header says what its design does about that.

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
build/nextplaid_tpu_torch/ and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "maxsim_bf16.cu"
SOURCE_INT8 = CSRC / "maxsim_int8.cu"
SOURCE_VARIANTS = CSRC / "maxsim_variants.cu"  # wrapper: ops/maxsim_variants.py
SOURCES = (SOURCE, SOURCE_INT8, SOURCE_VARIANTS)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nextplaid_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_TQ = 256
MAX_DIM = 256
MAX_DOCS = 65535 * 8  # grid.y limit times the bf16 kernel's 8 docs per block
INT8_DIMS = (32, 64, 128, 256)  # the int8 kernel's dims; others are padded
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


def build_library(source: Path = SOURCE) -> Path:
    """Compile one kernel source into a shared library (once per source and
    flags; the build log beside it holds ptxas' register and shared memory
    report). Returns the library's path."""
    tag = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    lib = BUILD_DIR / f"{source.stem}-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_bf16_scores.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.maxsim_bf16_scores.restype = i
    lib.maxsim_bf16_error_string.argtypes = [i]
    lib.maxsim_bf16_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library_int8() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE_INT8)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_int8_scores.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.maxsim_int8_scores.restype = i
    lib.maxsim_int8_error_string.argtypes = [i]
    lib.maxsim_int8_error_string.restype = ctypes.c_char_p
    return lib


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


def _launch(queries_flat, grid_tokens, doclens, tq) -> torch.Tensor:
    qf, d = queries_flat.shape
    nd, td, _ = grid_tokens.shape
    q_n = qf // tq
    out = torch.empty(q_n, nd, dtype=torch.float32, device=grid_tokens.device)
    if q_n == 0 or nd == 0:
        return out
    # The kernel takes tq in multiples of 16: pad each query with zero
    # token rows, which add exactly 0 to its scores.
    tq16 = -(-tq // 16) * 16
    if tq16 != tq:
        queries_flat = F.pad(
            queries_flat.view(q_n, tq, d), (0, 0, 0, tq16 - tq)
        ).reshape(q_n * tq16, d)
    lib = _library()
    with torch.cuda.device(grid_tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxsim_bf16_scores(
            queries_flat.data_ptr(), grid_tokens.data_ptr(),
            doclens.data_ptr(), out.data_ptr(),
            q_n, tq16, nd, td, d, stream,
        )
    if err != 0:
        msg = lib.maxsim_bf16_error_string(err).decode()
        raise RuntimeError(f"maxsim_bf16 kernel launch failed: {msg} ({err})")
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


def _launch_int8(queries_i8, qscales, grid_i8, scales, tq) -> torch.Tensor:
    qf, d = queries_i8.shape
    nd, td, _ = grid_i8.shape
    q_n = qf // tq
    out = torch.empty(q_n, nd, dtype=torch.float32, device=grid_i8.device)
    if q_n == 0 or nd == 0:
        return out
    # The kernel takes d in {32, 64, 128, 256}, tq in multiples of 8 and Td
    # in multiples of 4: pad with zero features, zero-scale query tokens and
    # zero-scale doc tokens, which add exactly 0 and mask nothing real.
    d_k = next(x for x in INT8_DIMS if x >= d)
    td4 = -(-td // 4) * 4
    if d_k != d or td4 != td:
        queries_i8 = F.pad(queries_i8, (0, d_k - d))
        grid_i8 = F.pad(grid_i8, (0, d_k - d, 0, td4 - td))
        scales = F.pad(scales, (0, td4 - td))
    tq8 = -(-tq // 8) * 8
    if tq8 != tq:
        queries_i8 = F.pad(
            queries_i8.view(q_n, tq, d_k), (0, 0, 0, tq8 - tq)
        ).reshape(q_n * tq8, d_k)
        qscales = F.pad(qscales.view(q_n, tq), (0, tq8 - tq)).reshape(-1)
    lib = _library_int8()
    with torch.cuda.device(grid_i8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxsim_int8_scores(
            queries_i8.data_ptr(), qscales.data_ptr(), grid_i8.data_ptr(),
            scales.data_ptr(), out.data_ptr(), q_n, tq8, nd, td4, d_k, stream,
        )
    if err != 0:
        msg = lib.maxsim_int8_error_string(err).decode()
        raise RuntimeError(f"maxsim_int8 kernel launch failed: {msg} ({err})")
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
