"""Document deletion: chunk mask rewrite + in-place IVF patch with renumbering.

A copy of `nextplaid_tpu.index.delete` (numpy on disk, no device work) of
the reference delete path (next-plaid src/delete.rs):
per-chunk masked rewrite of codes/residuals/doclens, an O(IVF) in-place posting
patch that drops deleted ids and renumbers survivors by their rank shift
(delete.rs:187-237, via a vectorized searchsorted instead of per-id binary
search), and cleanup of the raw-embedding side files (delete.rs:286-398).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from nextplaid_tpu_torch.index.config import Metadata
from nextplaid_tpu_torch.storage.npy import (
    IndexLayout,
    atomic_write_json,
    atomic_write_npy,
    file_lock,
    load_json,
    load_npy,
)


def delete_from_index(
    doc_ids: Sequence[int],
    index_path: str,
    clean_buffer: bool = True,
) -> int:
    """Delete documents by id. Returns the number actually deleted."""
    layout = IndexLayout(index_path)
    meta = Metadata.from_dict(load_json(layout.metadata))
    original_num_documents = meta.num_documents

    ids = np.unique(np.asarray(list(doc_ids), np.int64))

    final_num_documents = 0
    total_embeddings = 0
    doc_offset = 0
    deleted = 0

    for chunk_idx in range(meta.num_chunks):
        doclens = np.asarray(load_json(layout.chunk_doclens(chunk_idx)), np.int64)
        chunk_doc_ids = doc_offset + np.arange(len(doclens))
        delete_mask = np.isin(chunk_doc_ids, ids)
        keep_doclens = doclens[~delete_mask]
        deleted += int(delete_mask.sum())

        final_num_documents += len(keep_doclens)
        total_embeddings += int(keep_doclens.sum())
        if delete_mask.any():
            emb_keep = np.repeat(~delete_mask, doclens)
            codes = np.asarray(load_npy(layout.chunk_codes(chunk_idx), mmap=False))
            residuals = np.asarray(
                load_npy(layout.chunk_residuals(chunk_idx), mmap=False)
            )
            atomic_write_npy(layout.chunk_codes(chunk_idx), codes[emb_keep])
            atomic_write_npy(layout.chunk_residuals(chunk_idx), residuals[emb_keep])
            atomic_write_json(
                layout.chunk_doclens(chunk_idx),
                [int(x) for x in keep_doclens],
                indent=0,
            )
            chunk_meta = load_json(layout.chunk_metadata(chunk_idx))
            chunk_meta["num_documents"] = int(len(keep_doclens))
            chunk_meta["num_embeddings"] = int(emb_keep.sum())
            atomic_write_json(layout.chunk_metadata(chunk_idx), chunk_meta)
        doc_offset += len(doclens)

    # IVF in-place patch with survivor renumbering (delete.rs:187-237).
    old_ivf = np.asarray(load_npy(layout.ivf, mmap=False), np.int64)
    old_lengths = np.asarray(load_npy(layout.ivf_lengths, mmap=False), np.int64)
    keep = ~np.isin(old_ivf, ids)
    # Renumber: subtract the count of deleted ids below each survivor.
    shifts = np.searchsorted(ids, old_ivf, side="left")
    new_ivf = (old_ivf - shifts)[keep]
    # Per-centroid new lengths via segment sums over the keep mask.
    seg = np.repeat(np.arange(len(old_lengths)), old_lengths)
    new_lengths = np.bincount(
        seg[keep], minlength=len(old_lengths)
    ).astype(np.int32)
    atomic_write_npy(layout.ivf, new_ivf)
    atomic_write_npy(layout.ivf_lengths, new_lengths)

    new_meta = Metadata(
        num_chunks=meta.num_chunks,
        nbits=meta.nbits,
        num_partitions=meta.num_partitions,
        num_embeddings=total_embeddings,
        avg_doclen=(
            total_embeddings / final_num_documents if final_num_documents else 0.0
        ),
        num_documents=final_num_documents,
        embedding_dim=meta.embedding_dim,
        next_plaid_compatible=meta.next_plaid_compatible,
    )
    atomic_write_json(layout.metadata, new_meta.to_dict())

    if clean_buffer:
        _clean_embeddings_files(layout, ids, original_num_documents)
    return deleted


def _filter_split(flat_path, lengths_path, keep_mask: np.ndarray) -> None:
    from nextplaid_tpu_torch.index.update import _load_split, _save_split

    docs = _load_split(flat_path, lengths_path)
    kept = [d for d, k in zip(docs, keep_mask) if k]
    if kept:
        _save_split(flat_path, lengths_path, kept)
    else:
        Path(flat_path).unlink(missing_ok=True)
        Path(lengths_path).unlink(missing_ok=True)
    return None


def _clean_embeddings_files(
    layout: IndexLayout, ids: np.ndarray, original_num_documents: int
) -> None:
    """Filter embeddings.npy / buffer.npy by the deleted ids (delete.rs:286-398)."""
    root = layout.root
    # embeddings.npy: indexed by doc id from 0.
    lengths_path = root / "embeddings_lengths.json"
    if layout.embeddings.exists() and lengths_path.exists():
        lengths = load_json(lengths_path)
        keep = ~np.isin(np.arange(len(lengths)), ids)
        _filter_split(layout.embeddings, lengths_path, keep)

    # buffer.npy: the LAST buffer_len documents of the (pre-delete) index.
    blens_path = root / "buffer_lengths.json"
    if layout.buffer.exists() and blens_path.exists():
        lengths = load_json(blens_path)
        start = original_num_documents - len(lengths)
        buf_ids = start + np.arange(len(lengths))
        keep = ~np.isin(buf_ids, ids)
        _filter_split(layout.buffer, blens_path, keep)
        if (root / "buffer.npy").exists():
            atomic_write_json(
                root / "buffer_info.json", {"num_docs": int(keep.sum())}
            )
        else:
            (root / "buffer_info.json").unlink(missing_ok=True)


def delete_with_options(
    doc_ids: Sequence[int], index_path: str, delete_metadata: bool = True
) -> int:
    """Delete with optional metadata-db + FTS sync (index.rs:1805-1848).

    FTS suffix-delete optimization: when the deleted ids are exactly the tail
    of the id space, survivors keep their ids, so FTS rows stay aligned and
    only the deleted rows are removed — O(deleted). Any other delete shifts
    survivor ids and forces an FTS rebuild — O(total).
    """
    layout = IndexLayout(index_path)
    with file_lock(layout.lock):
        meta_before = None
        if layout.metadata.exists():
            meta_before = Metadata.from_dict(load_json(layout.metadata))
        n = delete_from_index(doc_ids, index_path)
        if delete_metadata and n > 0 and layout.metadata_db.exists():
            from nextplaid_tpu_torch.filtering import metadata as filtering
            from nextplaid_tpu_torch.filtering import text_search

            old_count = meta_before.num_documents if meta_before else 0
            valid = sorted({int(i) for i in doc_ids if 0 <= int(i) < old_count})
            suffix_start = old_count - len(valid)
            is_suffix = bool(valid) and valid[0] >= suffix_start

            filtering.delete(index_path, doc_ids)
            if is_suffix:
                text_search.delete(index_path, valid)
            else:
                text_search.rebuild(index_path)
    return n
