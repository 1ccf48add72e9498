"""Reconstruct per-document f32 embeddings from the compressed index.

PyTorch counterpart of `nextplaid_tpu.index.embeddings` (next-plaid
src/embeddings.rs:56-102): decompress codes + packed residuals back to
(approximately) the original token embeddings, for debugging, reranking
against raw vectors, re-indexing and export. The decompression runs on the
index's own device (`ops.codec.decompress_residuals`); only the per-document
slicing is host logic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from nextplaid_tpu_torch.index.container import DeviceIndex
from nextplaid_tpu_torch.ops import codec as codec_ops
from nextplaid_tpu_torch.utils.errors import DeleteError


def reconstruct_embeddings(
    index: DeviceIndex, doc_ids: Optional[Sequence[int]] = None
) -> List[np.ndarray]:
    """Decompress documents back to [tokens, dim] f32 (L2-renormalized).

    `doc_ids=None` reconstructs the whole index in document order.
    """
    if index.grid_only:
        raise DeleteError(
            "grid-only index has no compressed arrays to reconstruct "
            "from; reload with DeviceIndex.load"
        )
    if doc_ids is None:
        doc_ids = range(index.num_documents)
    doc_offsets = index.doc_offsets.cpu().numpy()
    doclens = index.doclens.cpu().numpy()

    out: List[np.ndarray] = []
    for doc_id in doc_ids:
        doc_id = int(doc_id)
        if doc_id < 0 or doc_id >= index.num_documents:
            raise DeleteError(
                f"doc id {doc_id} out of range (0..{index.num_documents - 1})"
            )
        start, n = int(doc_offsets[doc_id]), int(doclens[doc_id])
        emb = codec_ops.decompress_residuals(
            index.residuals[start : start + n],
            index.codes[start : start + n],
            index.centroids,
            index.bucket_weights,
            index.nbits,
        )
        out.append(emb.cpu().numpy().astype(np.float32))
    return out
