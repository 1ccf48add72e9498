"""The staged route's transient union grid in one CUDA launch
(csrc/union_grid.cu).

Stage 4 of staged search scores the batch's union of candidate docs with the
bf16 MaxSim kernel, over a grid it decompresses from the index's packed codes
each batch. `union_grid` writes that grid and its doclens in one pass, under
`index.search._build_union_grid`'s contract:
  grid    [rows, td_k, d] bf16: row r < cmax holds doc union_ids[r]; token t
          < min(doclens[id], td) of a stored doc (id < num_docs_padded) is
          bf16((c + w) / max(||c + w||, 1e-12)) with c its centroid row and w
          its bucket weights, unpacked in the codec's bit order
          (`ops.codec.unpack_buckets`), computed in f32 with IEEE square
          root and division and rounded once to bf16; every other token row,
          and every row past cmax, is zero;
  doclens [rows] int32: doclens[id] for id < num_documents, else 0
          (sentinel ids, ids past the index, the rows past cmax).
That is `decompress_docs(...).to(torch.bfloat16)` and `_union_doclens` with
only the order of the sum of squares changed: most elements are the same
bits, the rest one bf16 ulp apart.

Why one pass: the eager chain (`decompress_windows` over tiles of 2,048
docs) writes an int64 bucket tensor, two f32 gathers, their sum, norm and
quotient, a bf16 cast and a copy, several GB of device traffic a tile in
some fifteen launches, where the grid itself is the only output that has to
reach device memory. The kernel reads each live token's code, its packed
residual and its centroid row (from L2) and writes each grid element once.

The eager loop (`index.search._build_union_grid_eager`) is this kernel's
plain version and what CPU tensors take; `union_grid` itself takes CUDA
tensors only and launches or raises. Its library is compiled with nvcc at
first use into build/nextplaid_tpu_torch/ and loaded with ctypes, as the
MaxSim kernels' are (`ops.maxsim_kernel.build_library`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from nextplaid_tpu_torch.ops.maxsim_kernel import CSRC, MAX_DIM, build_library, load_once

SOURCE = CSRC / "union_grid.cu"
NBITS = (1, 2, 4, 8)  # the codec's packings
DIM_STEP = 16  # d a multiple of this up to MAX_DIM, as the bf16 MaxSim kernel takes
_COUNT_LOCK = threading.Lock()  # staged batches launch from several threads


def supported(device: torch.device, nbits: int, dim: int) -> bool:
    """Whether `union_grid` takes an index on `device` of `nbits` and `dim`."""
    return (device.type == "cuda" and nbits in NBITS
            and dim % DIM_STEP == 0 and 0 < dim <= MAX_DIM)


@load_once
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.union_grid_fill.argtypes = [p, i, i, p, p, p, p, p, p, i, i, i, i, p, p, i, i, i, p]
    lib.union_grid_fill.restype = i
    lib.union_grid_error_string.argtypes = [i]
    lib.union_grid_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(union_ids, doclens, doc_offsets, codes, residuals, centroids,
                  bucket_weights, nbits) -> None:
    dev = centroids.device
    if dev.type != "cuda":
        raise ValueError(f"union_grid takes CUDA tensors, got {dev}")
    for name, t, dtypes in (
        ("union_ids", union_ids, (torch.int32, torch.int64)),
        ("doclens", doclens, (torch.int32,)),
        ("doc_offsets", doc_offsets, (torch.int32,)),
        ("codes", codes, (torch.int32,)),
        ("residuals", residuals, (torch.uint8,)),
        ("centroids", centroids, (torch.float32,)),
        ("bucket_weights", bucket_weights, (torch.float32,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, centroids on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # Read as float4 and as 16- or 32-bit words of packed bits.
    for name, t in (("centroids", centroids), ("residuals", residuals)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    d = centroids.shape[1]
    if not supported(dev, nbits, d):
        raise ValueError(f"nbits {nbits} must be one of {NBITS} and d {d} a multiple "
                         f"of {DIM_STEP} up to {MAX_DIM}")
    if residuals.shape[1:] != (d * nbits // 8,):
        raise ValueError(f"residuals shape {tuple(residuals.shape)} does not hold "
                         f"d {d} at nbits {nbits}")
    if bucket_weights.shape != (1 << nbits,):
        raise ValueError(f"bucket_weights shape {tuple(bucket_weights.shape)} != ({1 << nbits},)")
    if doc_offsets.shape[0] < doclens.shape[0]:
        raise ValueError(f"{doc_offsets.shape[0]} doc offsets for {doclens.shape[0]} docs")


def union_grid(
    union_ids: torch.Tensor,
    doclens: torch.Tensor,
    doc_offsets: torch.Tensor,
    codes: torch.Tensor,
    residuals: torch.Tensor,
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    nbits: int,
    num_documents: int,
    td: int,
    rows: int,
    td_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The union grid [rows, td_k, d] bf16 and its doclens [rows] int32 of
    the docs `union_ids` [cmax] (cmax <= rows), their first `td` tokens
    decompressed from an index's tensors (`DeviceIndex`'s fields of the
    same names; `doclens` [num_docs_padded], 0 past `num_documents`). One
    launch on the current stream; raises on inputs it does not take."""
    _check_inputs(union_ids, doclens, doc_offsets, codes, residuals, centroids,
                  bucket_weights, nbits)
    cmax = union_ids.shape[0]
    if not 0 <= td <= td_k or rows < cmax:
        raise ValueError(f"td {td} must be within td_k {td_k}, cmax {cmax} within rows {rows}")
    d = centroids.shape[1]
    dev = centroids.device
    grid = torch.empty((rows, td_k, d), dtype=torch.bfloat16, device=dev)
    grid_doclens = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows == 0:
        return grid, grid_doclens
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.union_grid_fill(
            union_ids.data_ptr(), int(union_ids.dtype == torch.int64), cmax,
            doclens.data_ptr(), doc_offsets.data_ptr(), codes.data_ptr(),
            residuals.data_ptr(), centroids.data_ptr(), bucket_weights.data_ptr(),
            nbits, num_documents, doclens.shape[0], td, grid.data_ptr(),
            grid_doclens.data_ptr(), rows, td_k, d, stream,
        )
    if err != 0:
        msg = lib.union_grid_error_string(err).decode()
        raise RuntimeError(f"union_grid kernel launch failed: {msg} ({err})")
    with _COUNT_LOCK:
        union_grid.launches += 1
    return grid, grid_doclens


union_grid.launches = 0  # kernel launches since the last reset
