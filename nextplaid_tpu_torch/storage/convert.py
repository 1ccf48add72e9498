"""fast-plaid -> next-plaid on-disk format conversion.

A copy of `nextplaid_tpu.storage.convert` for the port: next-plaid's
`convert_fastplaid_to_nextplaid` (src/mmap.rs:1757-1811). fast-plaid writes
f16 float arrays, i64 ivf_lengths and `<u1` residual descriptors; next-plaid
(and this package's write path) standardizes on f32 / i32 / `|u1`.
Conversion rewrites files in place (atomic tmp+rename) and is idempotent.

`DeviceIndex.load` reads either format directly (numpy widens f16
transparently); this converter exists so a directory can be handed back to
the reference binaries after we touch it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nextplaid_tpu_torch.storage import native
from nextplaid_tpu_torch.storage.npy import atomic_write_npy, load_npy

_FLOAT_FILES = (
    "centroids.npy",
    "avg_residual.npy",
    "bucket_cutoffs.npy",
    "bucket_weights.npy",
)


def convert_fastplaid_to_nextplaid(index_path) -> bool:
    """Normalize a fast-plaid-written index directory in place.

    Returns True if anything was rewritten.
    """
    root = Path(index_path)
    converted = False

    for name in _FLOAT_FILES:
        path = root / name
        if not path.exists():
            continue
        arr = np.asarray(load_npy(path, mmap=False))
        if arr.dtype == np.float16:
            atomic_write_npy(path, native.f16_to_f32(arr))
            converted = True

    ivf_lengths = root / "ivf_lengths.npy"
    if ivf_lengths.exists():
        arr = np.asarray(load_npy(ivf_lengths, mmap=False))
        if arr.dtype == np.int64:
            atomic_write_npy(ivf_lengths, arr.astype(np.int32))
            converted = True

    # Residual chunk files: numpy always writes '|u1' for uint8, so a plain
    # round-trip normalizes fast-plaid's '<u1' descriptor.
    for path in sorted(root.glob("*.residuals.npy")):
        with open(path, "rb") as f:
            header = f.read(256)
        if b"'<u1'" in header:
            arr = np.asarray(load_npy(path, mmap=False), np.uint8)
            atomic_write_npy(path, arr)
            converted = True

    return converted
