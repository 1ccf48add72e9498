"""Incremental updates: buffer mode, centroid expansion, start-from-scratch.

PyTorch counterpart of `nextplaid_tpu.index.update` (next-plaid
src/update.rs and src/index.rs:1404-1591). The hot stages run on the device:

  - buffer mode (total pending < buffer_size=100): new docs are encoded with
    the EXISTING centroids and appended; their raw embeddings are stashed in
    buffer.npy (update.rs:132-259) for the eventual expansion;
  - centroid expansion (>= buffer_size): the buffered docs are deleted and
    re-indexed with the new ones after centroids trained on outlier tokens
    (distance > cluster_threshold; update.rs:490-608 as one f32 distance
    matmul a chunk and a mask) are appended;
  - start-from-scratch (index <= 999 docs with embeddings.npy in sync): a
    full rebuild with fresh k-means (index.rs:1456-1499).

On-disk chunk layout, IVF merge, weighted cluster-threshold updates and the
append-to-last-chunk (<2000 docs) rule follow the reference byte formats, so
the JAX package and this one write the same bytes from the same centroids.
On an RQ index (rq_coarse.npy and rq_fine.npy beside the centroids) buffer
mode assigns through the factored codebook, a centroid expansion drops the
sidecars (stage 1 falls back to the flat table) and a start-from-scratch
rebuild keeps the structure, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from nextplaid_tpu_torch.index import build as build_mod
from nextplaid_tpu_torch.index.config import (
    IndexConfig,
    Metadata,
    default_start_from_scratch,
)
from nextplaid_tpu_torch.ops import kmeans as kmeans_ops
from nextplaid_tpu_torch.ops import rq as rq_ops
from nextplaid_tpu_torch.storage.npy import (
    IndexLayout,
    atomic_write_json,
    atomic_write_npy,
    file_lock,
    load_json,
    load_npy,
)
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device
from nextplaid_tpu_torch.utils.errors import UpdateError
from nextplaid_tpu_torch.utils.progress import report as _progress

DEFAULT_BATCH_SIZE = 50_000
APPEND_TO_LAST_CHUNK_MAX_DOCS = 2000  # update.rs:810-812
# Tokens a distance block of `find_outliers`: [65536, K] f32 is 4.3 GB at
# K 16,384, which an 80 GB card holds beside any index it serves.
OUTLIER_CHUNK = 65536


@dataclass
class UpdateConfig:
    """Mirrors the reference `UpdateConfig` (update.rs:74-108).

    `force_cpu` is accepted for configuration compatibility and unused:
    device placement is the entry points' `device` argument."""

    batch_size: int = DEFAULT_BATCH_SIZE
    kmeans_niters: int = 4
    max_points_per_centroid: int = 256
    n_samples_kmeans: Optional[int] = None
    seed: int = 42
    start_from_scratch: int = dataclasses.field(
        default_factory=default_start_from_scratch
    )
    buffer_size: int = 100
    force_cpu: bool = False


def _has_rq(layout: IndexLayout) -> bool:
    return layout.rq_coarse.exists() and layout.rq_fine.exists()


# ---------------------------------------------------------------------------
# Buffer / raw-embedding persistence (update.rs:132-365)
# ---------------------------------------------------------------------------


def _load_split(flat_path, lengths_path) -> List[np.ndarray]:
    if not Path(flat_path).exists():
        return []
    flat = np.asarray(load_npy(flat_path, mmap=False), np.float32)
    if not Path(lengths_path).exists():
        return [flat]
    lengths = load_json(lengths_path)
    out, offset = [], 0
    for n in lengths:
        n = int(n)
        if offset + n > flat.shape[0]:
            break
        out.append(flat[offset : offset + n].copy())
        offset += n
    return out


def _save_split(flat_path, lengths_path, embeddings: Sequence[np.ndarray]) -> None:
    if not embeddings:
        return
    dim = int(np.asarray(embeddings[0]).shape[1])
    flat = np.concatenate(
        [np.asarray(e, np.float32).reshape(-1, dim) for e in embeddings]
    )
    atomic_write_npy(flat_path, flat)
    atomic_write_json(
        lengths_path, [int(np.asarray(e).shape[0]) for e in embeddings], indent=0
    )


def load_buffer(index_path) -> List[np.ndarray]:
    root = Path(index_path)
    return _load_split(root / "buffer.npy", root / "buffer_lengths.json")


def save_buffer(index_path, embeddings: Sequence[np.ndarray]) -> None:
    root = Path(index_path)
    _save_split(root / "buffer.npy", root / "buffer_lengths.json", embeddings)
    atomic_write_json(root / "buffer_info.json", {"num_docs": len(embeddings)})


def load_buffer_info(index_path) -> int:
    p = Path(index_path) / "buffer_info.json"
    if not p.exists():
        return 0
    return int(load_json(p).get("num_docs", 0))


def clear_buffer(index_path) -> None:
    root = Path(index_path)
    for name in ("buffer.npy", "buffer_lengths.json", "buffer_info.json"):
        (root / name).unlink(missing_ok=True)


def load_embeddings_npy(index_path) -> List[np.ndarray]:
    root = Path(index_path)
    return _load_split(root / "embeddings.npy", root / "embeddings_lengths.json")


def save_embeddings_npy(index_path, embeddings: Sequence[np.ndarray]) -> None:
    root = Path(index_path)
    _save_split(
        root / "embeddings.npy", root / "embeddings_lengths.json", embeddings
    )


def clear_embeddings_npy(index_path) -> None:
    root = Path(index_path)
    for name in ("embeddings.npy", "embeddings_lengths.json"):
        (root / name).unlink(missing_ok=True)


def embeddings_npy_exists(index_path) -> bool:
    return (Path(index_path) / "embeddings.npy").exists()


# ---------------------------------------------------------------------------
# Cluster threshold (update.rs:372-416)
# ---------------------------------------------------------------------------


def load_cluster_threshold(index_path) -> float:
    p = Path(index_path) / "cluster_threshold.npy"
    if not p.exists():
        raise FileNotFoundError("cluster_threshold.npy not found")
    return float(np.asarray(load_npy(p))[0])


def update_cluster_threshold(
    index_path, new_residual_norms: np.ndarray, old_total_embeddings: int
) -> None:
    """Weighted average of old and new 0.75-quantile thresholds."""
    new_count = len(new_residual_norms)
    if new_count == 0:
        return
    new_threshold = float(np.quantile(new_residual_norms, 0.75))
    p = Path(index_path) / "cluster_threshold.npy"
    if p.exists():
        old = float(np.asarray(load_npy(p))[0])
        total = old_total_embeddings + new_count
        final = (old * old_total_embeddings + new_threshold * new_count) / total
    else:
        final = new_threshold
    atomic_write_npy(p, np.asarray([final], np.float32))


# ---------------------------------------------------------------------------
# Outlier detection + centroid expansion (update.rs:490-751)
# ---------------------------------------------------------------------------


def _min_sq_dist(emb: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """min_c ||x - c||^2 through ||x||^2 - 2<x,c> + ||c||^2: one f32 matmul
    (TF32 off, see `resolve_device`) instead of the reference's tiled
    scalar loop (update.rs:475-608)."""
    x_sq = (emb * emb).sum(dim=1, keepdim=True)
    c_sq = (centroids * centroids).sum(dim=1)[None, :]
    d = x_sq - 2.0 * (emb @ centroids.T) + c_sq
    return torch.clamp(d.amin(dim=1), min=0.0)


def find_outliers(
    embeddings: np.ndarray,
    centroids: np.ndarray,
    threshold_sq: float,
    device: DeviceLike = None,
) -> np.ndarray:
    """Indices of embeddings farther than threshold from every centroid,
    computed on `device` ("cuda" when None)."""
    device = resolve_device(device)
    if embeddings.shape[0] == 0:
        return np.zeros(0, np.int64)
    cents = torch.tensor(np.asarray(centroids, np.float32), device=device)
    outlier_chunks = []
    for start in range(0, embeddings.shape[0], OUTLIER_CHUNK):
        emb = torch.from_numpy(
            np.ascontiguousarray(embeddings[start : start + OUTLIER_CHUNK], np.float32)
        ).to(device)
        d = _min_sq_dist(emb, cents).cpu().numpy()
        outlier_chunks.append(np.nonzero(d > threshold_sq)[0] + start)
    return np.concatenate(outlier_chunks)


def update_centroids(
    index_path,
    new_embeddings: Sequence[np.ndarray],
    cluster_threshold: float,
    config: UpdateConfig,
    device: DeviceLike = None,
) -> int:
    """Expand the centroid table with clusters of outlier tokens
    (update.rs:621-751), on `device` ("cuda" when None). Returns the number
    of centroids added."""
    device = resolve_device(device)
    layout = IndexLayout(index_path)
    if not layout.centroids.exists():
        return 0
    existing = np.asarray(load_npy(layout.centroids, mmap=False), np.float32)
    dim = existing.shape[1]
    flat = (
        np.concatenate(
            [np.asarray(e, np.float32).reshape(-1, dim) for e in new_embeddings]
        )
        if new_embeddings
        else np.zeros((0, dim), np.float32)
    )
    if flat.shape[0] == 0:
        return 0

    outlier_idx = find_outliers(flat, existing, cluster_threshold**2, device)
    if len(outlier_idx) == 0:
        return 0
    outliers = flat[outlier_idx]

    # k = max(1, ceil(n/max_points)) * 4, capped at n (update.rs:677-679)
    target_k = max(
        1, math.ceil(len(outliers) / config.max_points_per_centroid)
    ) * 4
    k_update = min(target_k, len(outliers))

    new_centroids = kmeans_ops.compute_kmeans(
        [outliers[i : i + 1] for i in range(len(outliers))],
        kmeans_ops.KMeansConfig(
            num_partitions=k_update,
            kmeans_niters=config.kmeans_niters,
            max_points_per_centroid=config.max_points_per_centroid,
            n_samples_kmeans=config.n_samples_kmeans,
            seed=config.seed,
        ),
        device=device,
    )
    k_new = new_centroids.shape[0]

    final = np.concatenate([existing, new_centroids])
    atomic_write_npy(layout.centroids, final)

    # Appended centroids are not coarse+fine pairs: drop the factorization,
    # so search and later updates take the flat path (correct, slower at
    # huge K).
    if layout.rq_coarse.exists() or layout.rq_fine.exists():
        logging.getLogger(__name__).warning(
            "centroid expansion on an RQ index: dropping rq_coarse/rq_fine "
            "sidecars (stage 1 falls back to the flat centroid table); "
            "rebuild the index to restore the factored structure"
        )
        layout.rq_coarse.unlink(missing_ok=True)
        layout.rq_fine.unlink(missing_ok=True)

    if layout.ivf_lengths.exists():
        old_lengths = np.asarray(load_npy(layout.ivf_lengths, mmap=False))
        new_lengths = np.zeros(final.shape[0], np.int32)
        new_lengths[: len(old_lengths)] = old_lengths
        atomic_write_npy(layout.ivf_lengths, new_lengths)

    if layout.metadata.exists():
        meta = load_json(layout.metadata)
        meta["num_partitions"] = int(final.shape[0])
        atomic_write_json(layout.metadata, meta)

    return k_new


# ---------------------------------------------------------------------------
# Low-level append (update.rs:771-1120)
# ---------------------------------------------------------------------------


def update_index(
    embeddings: Sequence[np.ndarray],
    index_path: str,
    batch_size: Optional[int] = None,
    update_threshold: bool = True,
    info_out: Optional[dict] = None,
    device: DeviceLike = None,
) -> int:
    """Append documents to the on-disk index with the CURRENT centroids.

    Encodes on `device` ("cuda" when None), appends chunk files (merging into
    the last chunk when it holds < 2000 docs, update.rs:800-827), merges the
    IVF, and rewrites metadata. Returns the number of documents added.

    When `info_out` is a dict, it receives `encoded = (codes i32, residuals
    u8, doclens i64)` for the just-added documents: the serving layer feeds
    these to `DeviceIndex.append_batch` so the device copy advances in
    O(batch) instead of a full reload.
    """
    device = resolve_device(device)
    batch_size = batch_size or DEFAULT_BATCH_SIZE
    layout = IndexLayout(index_path)
    meta = Metadata.from_dict(load_json(layout.metadata))

    centroids = np.asarray(load_npy(layout.centroids, mmap=False), np.float32)
    cutoffs = np.asarray(load_npy(layout.bucket_cutoffs, mmap=False), np.float32)
    weights = np.asarray(load_npy(layout.bucket_weights, mmap=False), np.float32)
    avg_res = np.asarray(load_npy(layout.avg_residual, mmap=False), np.float32)
    # An RQ index assigns through its codebook: the flat argmax could pick a
    # degenerate pair's cell (inv_norm 0), which queries never probe.
    rq_book = None
    if _has_rq(layout):
        rq_book = rq_ops.RQCodebook(
            coarse=np.asarray(load_npy(layout.rq_coarse, mmap=False), np.float32),
            fine=np.asarray(load_npy(layout.rq_fine, mmap=False), np.float32),
        )
    artifacts = build_mod.CodecArtifacts(
        centroids=centroids,
        bucket_cutoffs=cutoffs,
        bucket_weights=weights,
        avg_residual=avg_res,
        cluster_threshold=0.0,
        nbits=meta.nbits,
        rq=rq_book,
    )
    dim = centroids.shape[1]

    num_new = len(embeddings)
    old_num_docs = meta.num_documents
    old_total_emb = meta.num_embeddings

    # Append-to-last-chunk rule.
    start_chunk = meta.num_chunks
    append_to_last = False
    current_offset = old_total_emb
    if start_chunk > 0:
        last_meta_path = layout.chunk_metadata(start_chunk - 1)
        if last_meta_path.exists():
            last_meta = load_json(last_meta_path)
            if last_meta.get("num_documents", 0) < APPEND_TO_LAST_CHUNK_MAX_DOCS:
                start_chunk -= 1
                append_to_last = True
                current_offset = last_meta.get(
                    "embedding_offset",
                    old_total_emb - last_meta.get("num_embeddings", 0),
                )

    all_new_codes_per_doc: List[np.ndarray] = []
    new_doclens: List[int] = []
    residual_norms: List[np.ndarray] = []
    new_residuals_chunks: List[np.ndarray] = []

    n_new_chunks = max(1, math.ceil(num_new / batch_size)) if num_new else 0
    for i in range(n_new_chunks):
        chunk_docs = [
            np.asarray(e, np.float32)
            for e in embeddings[i * batch_size : (i + 1) * batch_size]
        ]
        flat = (
            np.concatenate([d.reshape(-1, dim) for d in chunk_docs])
            if chunk_docs
            else np.zeros((0, dim), np.float32)
        )
        encoded = build_mod.encode_chunk(
            chunk_docs, artifacts, torch.from_numpy(flat).to(device)
        )

        if update_threshold and sum(encoded.doclens) > 0:
            residuals = flat - centroids[encoded.codes]
            residual_norms.append(np.linalg.norm(residuals, axis=1))

        codes_list = encoded.codes
        residuals_list = encoded.residuals
        doclens_list = list(encoded.doclens)
        if info_out is not None:
            new_residuals_chunks.append(encoded.residuals)

        offset = 0
        for n in encoded.doclens:
            all_new_codes_per_doc.append(codes_list[offset : offset + n])
            new_doclens.append(int(n))
            offset += n

        chunk_idx = start_chunk + i
        if i == 0 and append_to_last and layout.chunk_doclens(chunk_idx).exists():
            old_doclens = load_json(layout.chunk_doclens(chunk_idx))
            old_codes = np.asarray(load_npy(layout.chunk_codes(chunk_idx), mmap=False))
            old_res = np.asarray(
                load_npy(layout.chunk_residuals(chunk_idx), mmap=False)
            )
            codes_list = np.concatenate([old_codes, codes_list])
            residuals_list = np.concatenate([old_res, residuals_list])
            doclens_list = list(old_doclens) + doclens_list

        atomic_write_npy(layout.chunk_codes(chunk_idx), codes_list.astype(np.int64))
        atomic_write_npy(layout.chunk_residuals(chunk_idx), residuals_list)
        atomic_write_json(layout.chunk_doclens(chunk_idx), doclens_list, indent=0)
        atomic_write_json(
            layout.chunk_metadata(chunk_idx),
            {
                "num_documents": len(doclens_list),
                "num_embeddings": int(codes_list.shape[0]),
                "embedding_offset": int(current_offset),
            },
        )
        current_offset += int(codes_list.shape[0])

    if update_threshold and residual_norms:
        update_cluster_threshold(
            index_path, np.concatenate(residual_norms), old_total_emb
        )

    if info_out is not None:
        info_out["encoded"] = (
            (
                np.concatenate(all_new_codes_per_doc).astype(np.int32)
                if all_new_codes_per_doc
                else np.zeros(0, np.int32)
            ),
            (
                np.concatenate(new_residuals_chunks)
                if new_residuals_chunks
                else np.zeros((0, dim * meta.nbits // 8), np.uint8)
            ),
            np.asarray(new_doclens, np.int64),
        )

    # IVF merge (update.rs:1000-1081).
    num_centroids = centroids.shape[0]
    old_ivf = (
        np.asarray(load_npy(layout.ivf, mmap=False), np.int64)
        if layout.ivf.exists()
        else np.zeros(0, np.int64)
    )
    old_lengths = (
        np.asarray(load_npy(layout.ivf_lengths, mmap=False), np.int64)
        if layout.ivf_lengths.exists()
        else np.zeros(num_centroids, np.int64)
    )
    if len(old_lengths) < num_centroids:
        old_lengths = np.concatenate(
            [old_lengths, np.zeros(num_centroids - len(old_lengths), np.int64)]
        )

    new_ids, new_lengths = build_mod.build_ivf(
        np.concatenate(all_new_codes_per_doc)
        if all_new_codes_per_doc
        else np.zeros(0, np.int64),
        np.asarray(new_doclens, np.int64),
        num_centroids,
    )
    # Offset new doc ids by the existing doc count.
    new_ids = new_ids + old_num_docs

    old_offsets = np.zeros(num_centroids + 1, np.int64)
    np.cumsum(old_lengths, out=old_offsets[1:])
    new_offsets = np.zeros(num_centroids + 1, np.int64)
    np.cumsum(new_lengths, out=new_offsets[1:])

    merged_data: List[np.ndarray] = []
    merged_lengths = np.zeros(num_centroids, np.int32)
    for c in range(num_centroids):
        olds = old_ivf[old_offsets[c] : old_offsets[c + 1]]
        news = new_ids[new_offsets[c] : new_offsets[c + 1]]
        if len(news) == 0 and len(olds) == 0:
            continue
        merged = np.unique(np.concatenate([olds, news]))
        merged_data.append(merged)
        merged_lengths[c] = len(merged)
    atomic_write_npy(
        layout.ivf,
        np.concatenate(merged_data) if merged_data else np.zeros(0, np.int64),
    )
    atomic_write_npy(layout.ivf_lengths, merged_lengths)

    # Metadata.
    new_tokens = int(sum(new_doclens))
    total_docs = old_num_docs + num_new
    new_meta = Metadata(
        num_chunks=start_chunk + n_new_chunks,
        nbits=meta.nbits,
        num_partitions=num_centroids,
        num_embeddings=old_total_emb + new_tokens,
        avg_doclen=(
            (meta.avg_doclen * old_num_docs + new_tokens) / total_docs
            if total_docs
            else 0.0
        ),
        num_documents=total_docs,
        embedding_dim=meta.embedding_dim or centroids.shape[1],
        next_plaid_compatible=True,
    )
    atomic_write_json(layout.metadata, new_meta.to_dict())
    return num_new


# ---------------------------------------------------------------------------
# High-level 3-path update (index.rs:1431-1591)
# ---------------------------------------------------------------------------


def update(
    embeddings: Sequence[np.ndarray],
    index_path: str,
    config: Optional[UpdateConfig] = None,
    info_out: Optional[dict] = None,
    device: DeviceLike = None,
) -> List[int]:
    """Add documents to an existing on-disk index, computing on `device`
    ("cuda" when None). Returns the assigned doc ids.

    `info_out` (optional dict) receives `mode` ("scratch" | "expand" |
    "buffer") and, in buffer mode only, the `encoded` batch (see
    update_index): buffer-mode appends keep the centroids, so a served
    DeviceIndex can advance in place with `append_batch`; the other modes
    change centroids or codes and need a reload."""
    from nextplaid_tpu_torch.index import delete as delete_mod

    device = resolve_device(device)
    config = config or UpdateConfig()
    layout = IndexLayout(index_path)
    embeddings = [np.asarray(e, np.float32) for e in embeddings]
    num_new = len(embeddings)

    with file_lock(layout.lock):
        meta = Metadata.from_dict(load_json(layout.metadata))

        # --- Start-from-scratch mode.
        if meta.num_documents <= config.start_from_scratch:
            existing = load_embeddings_npy(index_path)
            if len(existing) == meta.num_documents:
                start_id = len(existing)
                combined = existing + embeddings
                index_config = IndexConfig(
                    nbits=meta.nbits,
                    batch_size=config.batch_size,
                    seed=config.seed,
                    kmeans_niters=config.kmeans_niters,
                    max_points_per_centroid=config.max_points_per_centroid,
                    n_samples_kmeans=config.n_samples_kmeans,
                    start_from_scratch=config.start_from_scratch,
                    # The rebuild keeps the index's centroid structure.
                    centroid_structure="rq" if _has_rq(layout) else "auto",
                )
                build_mod.create_index(combined, index_path, index_config, device=device)
                if (
                    len(combined) > config.start_from_scratch
                    and embeddings_npy_exists(index_path)
                ):
                    clear_embeddings_npy(index_path)
                if info_out is not None:
                    info_out["mode"] = "scratch"
                return list(range(start_id, start_id + num_new))

        # --- Buffer / expansion paths.
        buffer = load_buffer(index_path)
        total_new = num_new + len(buffer)

        if total_new >= config.buffer_size:
            _progress("centroid_expansion", processed=0, total=total_new)
            num_buffered = load_buffer_info(index_path)
            if num_buffered > 0 and meta.num_documents >= num_buffered:
                start_del = meta.num_documents - num_buffered
                delete_mod.delete_from_index(
                    list(range(start_del, meta.num_documents)),
                    index_path,
                    clean_buffer=False,
                )
                meta = Metadata.from_dict(load_json(layout.metadata))
            start_id = meta.num_documents + len(buffer)
            combined = buffer + embeddings
            try:
                threshold = load_cluster_threshold(index_path)
            except FileNotFoundError:
                threshold = None
            if threshold is not None:
                update_centroids(index_path, combined, threshold, config, device)
            clear_buffer(index_path)
            if info_out is not None:
                info_out["mode"] = "expand"
            update_index(
                combined, index_path, config.batch_size, update_threshold=True,
                device=device,
            )
        else:
            _progress("buffer_append", processed=0, total=num_new)
            start_id = meta.num_documents
            save_buffer(index_path, buffer + embeddings)
            if info_out is not None:
                info_out["mode"] = "buffer"
            update_index(
                embeddings, index_path, config.batch_size,
                update_threshold=False, info_out=info_out, device=device,
            )

    return list(range(start_id, start_id + num_new))


def update_or_create(
    embeddings: Sequence[np.ndarray],
    index_path: str,
    index_config: Optional[IndexConfig] = None,
    update_config: Optional[UpdateConfig] = None,
    info_out: Optional[dict] = None,
    device: DeviceLike = None,
) -> List[int]:
    """Primary ingest entry (index.rs:1644-1665), on `device` ("cuda" when
    None). Returns the assigned doc ids."""
    device = resolve_device(device)
    layout = IndexLayout(index_path)
    if layout.metadata.exists():
        return update(
            embeddings, index_path, update_config, info_out=info_out, device=device
        )
    build_mod.create_index(embeddings, index_path, index_config, device=device)
    if info_out is not None:
        info_out["mode"] = "create"
    return list(range(len(embeddings)))


def update_or_create_with_metadata(
    embeddings: Sequence[np.ndarray],
    index_path: str,
    index_config: Optional[IndexConfig] = None,
    update_config: Optional[UpdateConfig] = None,
    metadata: Optional[Sequence[dict]] = None,
    info_out: Optional[dict] = None,
    device: DeviceLike = None,
) -> List[int]:
    """Ingest vectors + metadata + FTS in one call (index.rs:1719-1761), on
    `device` ("cuda" when None).

    On a metadata-write failure the just-added documents are rolled back out
    of the vector index so counts stay in sync (the reference API does this
    in documents.rs:474-485).
    """
    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.filtering import text_search
    from nextplaid_tpu_torch.index import delete as delete_mod

    if metadata is not None and len(metadata) != len(embeddings):
        raise UpdateError(
            f"Metadata length ({len(metadata)}) must match embeddings length "
            f"({len(embeddings)})"
        )
    index_config = index_config or IndexConfig()
    doc_ids = update_or_create(
        embeddings, index_path, index_config, update_config, info_out=info_out,
        device=device,
    )
    if metadata is not None:
        try:
            if filtering.exists(index_path):
                filtering.update(index_path, metadata, doc_ids)
            else:
                filtering.create(index_path, metadata, doc_ids)
            text_search.index(
                index_path, metadata, doc_ids, index_config.fts_tokenizer
            )
        except BaseException:
            delete_mod.delete_from_index(doc_ids, index_path)
            raise
    return doc_ids
