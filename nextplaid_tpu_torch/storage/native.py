"""ctypes bindings to the native host runtime (native/nextplaid_host.cpp).

Copy of `nextplaid_tpu.storage.native` for the port. The C++ library speeds
up the IO-bound host path: the chunk merge into one load buffer, residual
pack/unpack, bucketize and f16 widening. Every entry point keeps its numpy
version (`*_reference`), which is both what the tests hold the library
against and what the package does where no compiler is found.

The library is compiled from the repo's `native/nextplaid_host.cpp`, read as
a source and never written to, with g++ at first use, into
`build/nextplaid_tpu_torch/` beside the CUDA kernels (the file name carries
a hash of the source and the flags).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "nextplaid_host.cpp"
BUILD_DIR = _ROOT / "build" / "nextplaid_tpu_torch"
# No -march=native: the library must load on whichever host a copy of the
# checkout runs on.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnextplaid_host-{h.hexdigest()[:12]}.so"


def _build(lib_path: Path) -> None:
    """Compile the library with g++ (atomic: a temporary file renamed into
    place, so concurrent processes never load a half-written file)."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True,
            timeout=120,
            check=True,
        )
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not SOURCE.exists():
            return None
        lib_path = library_path()
        if not lib_path.exists() and not _build_attempted:
            _build_attempted = True
            _build(lib_path)
        if not lib_path.exists():
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.np_chunks_total_bytes.argtypes = [p, i, p]
        lib.np_chunks_total_bytes.restype = i64
        lib.np_merge_chunks_into.argtypes = [p, i, p, i64]
        lib.np_merge_chunks_into.restype = i64
        lib.np_pack_residuals.argtypes = [p, i64, i64, i, p]
        lib.np_pack_residuals.restype = i
        lib.np_unpack_residuals.argtypes = [p, i64, i64, i, p]
        lib.np_unpack_residuals.restype = i
        lib.np_bucketize.argtypes = [p, i64, p, i, p]
        lib.np_bucketize.restype = i
        lib.np_f16_to_f32.argtypes = [p, i64, p]
        lib.np_f16_to_f32.restype = i
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def merge_chunk_payloads(
    paths: Sequence[str], dtype: np.dtype, trailing: Tuple[int, ...] = ()
) -> Optional[np.ndarray]:
    """Concatenate the payloads of same-dtype NPY chunk files into one array
    via the native mmap+memcpy pass; None if the library is unavailable.
    (Its numpy version is `np.concatenate` of the loaded chunks.)"""
    lib = _load()
    if lib is None or not paths:
        return None
    arr = _paths_array(paths)
    rows = ctypes.c_int64(0)
    total = lib.np_chunks_total_bytes(arr, len(paths), ctypes.byref(rows))
    if total < 0:
        return None
    out = np.empty(total // np.dtype(dtype).itemsize, dtype=dtype)
    got = lib.np_merge_chunks_into(
        arr, len(paths), out.ctypes.data, ctypes.c_int64(out.nbytes)
    )
    if got < 0:
        return None
    n_rows = int(rows.value)
    if trailing:
        return out.reshape(n_rows, *trailing)
    return out


def pack_residuals(buckets: np.ndarray, nbits: int) -> np.ndarray:
    """[n, dim] int32 buckets -> [n, dim*nbits/8] u8 (native or numpy)."""
    buckets = np.ascontiguousarray(buckets, np.int32)
    n, dim = buckets.shape
    out = np.empty((n, dim * nbits // 8), np.uint8)
    lib = _load()
    if lib is not None:
        rc = lib.np_pack_residuals(buckets.ctypes.data, n, dim, nbits, out.ctypes.data)
        if rc == 0:
            return out
    return pack_residuals_reference(buckets, nbits)


def pack_residuals_reference(buckets: np.ndarray, nbits: int) -> np.ndarray:
    """numpy version of `pack_residuals` (the layout of ops/codec.py's
    `pack_buckets`)."""
    buckets = np.ascontiguousarray(buckets, np.int32)
    n, dim = buckets.shape
    vpb = 8 // nbits
    rev = _bit_reverse_table(nbits)
    rv = rev[buckets].astype(np.uint8).reshape(n, dim // vpb, vpb)
    shifts = np.array([8 - nbits * (k + 1) for k in range(vpb)], np.uint8)
    return np.bitwise_or.reduce(rv << shifts, axis=-1).astype(np.uint8)


def unpack_residuals(packed: np.ndarray, nbits: int) -> np.ndarray:
    """[n, dim*nbits/8] u8 -> [n, dim] int32."""
    packed = np.ascontiguousarray(packed, np.uint8)
    n, packed_dim = packed.shape
    dim = packed_dim * (8 // nbits)
    out = np.empty((n, dim), np.int32)
    lib = _load()
    if lib is not None:
        rc = lib.np_unpack_residuals(packed.ctypes.data, n, dim, nbits, out.ctypes.data)
        if rc == 0:
            return out
    return unpack_residuals_reference(packed, nbits)


def unpack_residuals_reference(packed: np.ndarray, nbits: int) -> np.ndarray:
    """numpy version of `unpack_residuals`."""
    packed = np.ascontiguousarray(packed, np.uint8)
    n, packed_dim = packed.shape
    vpb = 8 // nbits
    mask = (1 << nbits) - 1
    rev = _bit_reverse_table(nbits).astype(np.int32)
    shifts = np.array([8 - nbits * (k + 1) for k in range(vpb)], np.uint8)
    segs = (packed[..., None] >> shifts) & mask
    return rev[segs].reshape(n, packed_dim * vpb)


def bucketize(values: np.ndarray, cutoffs: np.ndarray) -> np.ndarray:
    """Bucket of each value: the count of cutoffs below it."""
    values = np.ascontiguousarray(values, np.float32)
    cutoffs = np.ascontiguousarray(cutoffs, np.float32)
    lib = _load()
    if lib is not None:
        out = np.empty(values.size, np.int32)
        rc = lib.np_bucketize(
            values.ctypes.data, values.size, cutoffs.ctypes.data, cutoffs.size,
            out.ctypes.data,
        )
        if rc == 0:
            return out.reshape(values.shape)
    return bucketize_reference(values, cutoffs)


def bucketize_reference(values: np.ndarray, cutoffs: np.ndarray) -> np.ndarray:
    """numpy version of `bucketize`."""
    values = np.asarray(values, np.float32)
    cutoffs = np.asarray(cutoffs, np.float32)
    return np.searchsorted(cutoffs, values, side="left").astype(np.int32)


def f16_to_f32(arr: np.ndarray) -> np.ndarray:
    """Widen to float32 (natively for float16 input)."""
    arr = np.ascontiguousarray(arr)
    lib = _load()
    if lib is not None and arr.dtype == np.float16:
        out = np.empty(arr.size, np.float32)
        rc = lib.np_f16_to_f32(arr.view(np.uint16).ctypes.data, arr.size, out.ctypes.data)
        if rc == 0:
            return out.reshape(arr.shape)
    return f16_to_f32_reference(arr)


def f16_to_f32_reference(arr: np.ndarray) -> np.ndarray:
    """numpy version of `f16_to_f32`."""
    return np.asarray(arr).astype(np.float32)


def _bit_reverse_table(nbits: int) -> np.ndarray:
    size = 1 << nbits
    table = np.zeros(size, np.uint8)
    for v in range(size):
        r = 0
        for b in range(nbits):
            if v & (1 << b):
                r |= 1 << (nbits - 1 - b)
        table[v] = r
    return table
