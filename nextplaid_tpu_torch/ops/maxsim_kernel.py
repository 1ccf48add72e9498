"""Fused MaxSim over the pinned bf16 token grid: a CUDA kernel and its plain
PyTorch version.

The kernel (csrc/maxsim_bf16.cu) replaces the Pallas kernel
`nextplaid_tpu.ops.maxsim_kernel.maxsim_grid_scores` / `_kernel`. It is
compute-bound on an H100 (about 10,000 operations per grid byte at the main
path's shapes); the source's header says what its design does about that.

Layout contract (as the JAX package's, with doclens flat):
  queries_flat [Q*Tq, d] bf16, padded query tokens are zero rows, so they
               contribute exactly 0 (the kernel takes no query mask);
  grid_tokens  [ND, Td, d] bf16, token rows at or beyond a doc's length zero;
  doclens      [ND] int32 (0 for padding docs).
Output [Q, ND] f32: scores[q, n] = sum_t max_{j < doclens[n]} <q_t, grid[n, j]>,
bf16 products summed in f32; a doc with doclens == 0 scores 0.

`maxsim_grid_scores` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; a failed build or launch raises. The library is
compiled with nvcc at first use into build/nextplaid_tpu_torch/ and loaded
with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "maxsim_bf16.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nextplaid_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MAX_TQ = 256
MAX_DIM = 256
MAX_DOCS = 65535 * 8  # grid.y limit times the kernel's 8 docs per block


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_library() -> Path:
    """Compile csrc/maxsim_bf16.cu into a shared library (once per source
    and flags; the build log beside it holds ptxas' register and shared
    memory report). Returns the library's path."""
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    lib = BUILD_DIR / f"maxsim_bf16-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maxsim_bf16_scores.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.maxsim_bf16_scores.restype = i
    lib.maxsim_bf16_error_string.argtypes = [i]
    lib.maxsim_bf16_error_string.restype = ctypes.c_char_p
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
