"""Merged-chunk load cache keyed by a chunk manifest.

A copy of `nextplaid_tpu.storage.merge_cache` for the port. next-plaid
avoids re-merging chunk files on every process start by persisting the
merged buffer next to the index with a manifest of chunk mtimes; when the
manifest still matches, load is an mmap of the merged file (src/mmap.rs:
1081-1300, the mtime fast path). `load_host_arrays` merges
`{i}.codes.npy` / `{i}.residuals.npy` once, stores the merged arrays under
`merged/` with a manifest, and later loads mmap the merged files directly
when no chunk changed: O(changed) instead of O(corpus) host work per cold
start.

Any mutation that rewrites or appends a chunk (update, delete, ingest
flush) changes that chunk's (mtime_ns, size) and invalidates the manifest
automatically; the next load re-merges and refreshes the cache.

The cache only pays for itself when the copy is material: it activates at
`num_chunks >= 2` and total payload >= 64 MB (NEXT_PLAID_MERGE_CACHE=1
forces it on for any size, =0 disables it entirely).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from nextplaid_tpu_torch.storage.npy import (
    atomic_write_json,
    atomic_write_npy,
    file_lock,
    load_json,
    load_npy,
)

_VERSION = 1
_MIN_BYTES = 64 << 20


def _dir(root: Path) -> Path:
    return Path(root) / "merged"


def _manifest_path(root: Path) -> Path:
    return _dir(root) / "manifest.json"


def _chunk_entries(paths: Sequence[str]) -> Optional[List[dict]]:
    entries = []
    for p in paths:
        try:
            st = os.stat(p)
        except OSError:
            return None
        entries.append(
            {
                "name": os.path.basename(p),
                "mtime_ns": st.st_mtime_ns,
                "size": st.st_size,
            }
        )
    return entries


def enabled(total_bytes: int, num_chunks: int) -> bool:
    flag = os.environ.get("NEXT_PLAID_MERGE_CACHE", "auto")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return num_chunks >= 2 and total_bytes >= _MIN_BYTES


def load_merged(
    root: Path, code_paths: Sequence[str], res_paths: Sequence[str]
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Return (codes, residuals) mmapped from the merged cache, or None when
    there is no cache or any chunk changed since it was written."""
    mp = _manifest_path(root)
    if not mp.exists():
        return None
    try:
        manifest = load_json(mp)
    except (OSError, ValueError):
        return None
    if manifest.get("version") != _VERSION:
        return None
    current = _chunk_entries(list(code_paths) + list(res_paths))
    if current is None or manifest.get("chunks") != current:
        return None
    d = _dir(root)
    try:
        codes = load_npy(d / "codes.npy", mmap=True)
        residuals = load_npy(d / "residuals.npy", mmap=True)
    except (OSError, ValueError):
        return None
    return np.asarray(codes), np.asarray(residuals)


def store_merged(
    root: Path,
    codes: np.ndarray,
    residuals: np.ndarray,
    code_paths: Sequence[str],
    res_paths: Sequence[str],
) -> None:
    """Persist merged payloads + manifest (atomic, best-effort: a failed
    write must never fail the load that produced the arrays)."""
    entries = _chunk_entries(list(code_paths) + list(res_paths))
    if entries is None:
        return
    d = _dir(root)
    try:
        d.mkdir(parents=True, exist_ok=True)
        with file_lock(d / ".lock"):
            atomic_write_npy(d / "codes.npy", np.ascontiguousarray(codes))
            atomic_write_npy(
                d / "residuals.npy", np.ascontiguousarray(residuals)
            )
            # Manifest goes LAST: a crash between payloads and manifest
            # leaves a stale-manifest-free cache that simply misses.
            atomic_write_json(
                _manifest_path(root),
                {"version": _VERSION, "chunks": entries},
            )
    except OSError:
        pass
