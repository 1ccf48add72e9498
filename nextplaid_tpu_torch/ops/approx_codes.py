"""Staged stage 3b, the reference approximate score, in one CUDA launch
(csrc/approx_codes.cu).

Stage 3b of staged search re-ranks each query's pool of candidates by the
reference's approximate score (search.rs:448-457): for each query token, the
best centroid score among the candidate's token codes, summed over the query
tokens. `approx_codes` computes it under
`index.search._approx_codes_scores_eager`'s "gather" contract:
  out [Q, pool] f32: for q and slot i with id = ids[q, i] < num_documents,
      sum over query tokens j with qmask[q, j] of m if m is finite else 0,
      m = max over the doc's first min(doclen, td) tokens t of
      s_t[q, codes[t], j] (-inf for a doc with no tokens);
      0 for ids at or past num_documents (sentinels, the capacity slot).
The lookups and the maxima are the eager loop's, exact f32; the sum over
query tokens is taken in f64 and rounded once, which is the eager loop run
on the table in f64 (`_approx_codes_scores_eager(index, s_masked.double(),
...)`, its plain version here). The eager loop's own f32 sum differs from it
by that sum's rounding, which passes a millionth of a score where the terms
cancel.

Why one pass: the eager loop writes each tile's looked-up scores, a
[Q, tile, Td, Tq] f32 block (7.5 GB over a LoTTE staged batch's pool),
clones it to mask it and reduces it, ~400 launches and ~39 GB of device
traffic for a [Q, pool] result. The kernel keeps the running max of each
query token in a register and reads each live token's table row once, from
L2, where a query's table stays while its candidates are scored.

The eager loop is this kernel's plain version and what CPU tensors take;
`approx_codes` itself takes CUDA tensors only and launches or raises. Its
library is compiled with nvcc at first use into build/nextplaid_tpu_torch/
and loaded with ctypes, as the MaxSim kernels' are
(`ops.maxsim_kernel.build_library`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from nextplaid_tpu_torch.ops.maxsim_kernel import CSRC, build_library, load_once

SOURCE = CSRC / "approx_codes.cu"
_COUNT_LOCK = threading.Lock()  # staged batches launch from several threads


def supported(device: torch.device) -> bool:
    """Whether `approx_codes` takes tensors on `device`: any CUDA device,
    at any number of query tokens."""
    return device.type == "cuda"


@load_once
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SOURCE)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.approx_codes_scores.argtypes = [p, p, p, i, i, i, i, i, p, p, p, i, i, i, i, p, p]
    lib.approx_codes_scores.restype = i
    lib.approx_codes_error_string.argtypes = [i]
    lib.approx_codes_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(s_t, qmask, ids, doclens, doc_offsets, codes) -> None:
    dev = s_t.device
    if not supported(dev):
        raise ValueError(f"approx_codes takes CUDA tensors, got {dev}")
    for name, t, dtypes in (
        ("s_t", s_t, (torch.float32,)),
        ("qmask", qmask, (torch.bool,)),
        ("ids", ids, (torch.int32, torch.int64)),
        ("doclens", doclens, (torch.int32,)),
        ("doc_offsets", doc_offsets, (torch.int32,)),
        ("codes", codes, (torch.int32,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, s_t on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if s_t.dim() != 3 or qmask.shape != (s_t.shape[0], s_t.shape[2]):
        raise ValueError(f"s_t {tuple(s_t.shape)} must be [Q, K, Tq] and qmask "
                         f"{tuple(qmask.shape)} [Q, Tq]")
    if ids.dim() != 2 or ids.shape[0] != s_t.shape[0]:
        raise ValueError(f"ids {tuple(ids.shape)} must be [Q, pool] with Q {s_t.shape[0]}")
    if s_t.shape[2] == 0:
        raise ValueError("s_t has no query tokens")
    if doc_offsets.shape[0] < doclens.shape[0] or doclens.shape[0] == 0 or codes.shape[0] == 0:
        raise ValueError(f"{doc_offsets.shape[0]} doc offsets for {doclens.shape[0]} docs, "
                         f"{codes.shape[0]} codes")


def approx_codes(
    s_t: torch.Tensor,
    qmask: torch.Tensor,
    ids: torch.Tensor,
    doclens: torch.Tensor,
    doc_offsets: torch.Tensor,
    codes: torch.Tensor,
    num_documents: int,
    td: int,
) -> torch.Tensor:
    """The approximate scores [Q, pool] f32 of the candidates `ids` [Q, pool]
    against the transposed centroid scores `s_t` [Q, K, Tq] (-inf rows for
    masked query tokens) under `qmask` [Q, Tq], each candidate's first `td`
    tokens read through an index's `doclens`, `doc_offsets` and `codes`
    (`DeviceIndex`'s fields). One launch on the current stream; raises on
    inputs it does not take."""
    _check_inputs(s_t, qmask, ids, doclens, doc_offsets, codes)
    q_n, k, tq = s_t.shape
    pool = ids.shape[1]
    out = torch.empty((q_n, pool), dtype=torch.float32, device=s_t.device)
    if q_n == 0 or pool == 0:
        return out
    lib = _library()
    with torch.cuda.device(s_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.approx_codes_scores(
            s_t.data_ptr(), qmask.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            q_n, pool, k, tq, doclens.data_ptr(), doc_offsets.data_ptr(), codes.data_ptr(),
            codes.shape[0], num_documents, doclens.shape[0], td, out.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.approx_codes_error_string(err).decode()
        raise RuntimeError(f"approx_codes kernel launch failed: {msg} ({err})")
    with _COUNT_LOCK:
        approx_codes.launches += 1
    return out


approx_codes.launches = 0  # kernel launches since the last reset
