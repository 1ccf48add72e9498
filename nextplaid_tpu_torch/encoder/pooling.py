"""Hierarchical token pooling: compress a document's token embeddings by
clustering similar tokens and averaging each cluster.

A copy of `nextplaid_tpu.encoder.pooling` for the port: next-plaid-onnx's
`pool_document_embeddings` / `pool_embeddings_hierarchical` (src/lib.rs:
1632-1643, 2246-2317; its hierarchy.rs reimplements scipy): cosine pdist ->
Ward linkage -> fcluster maxclust, with scipy directly.

Host-side by design: pooling is a per-document ragged O(T^2) op that feeds
*indexing*, not the search hot path.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import pdist


def pool_embeddings_hierarchical(
    embeddings: np.ndarray,
    pool_factor: int,
    protected_tokens: int = 1,
) -> np.ndarray:
    """Pool one document's [tokens, dim] embeddings down to roughly
    ``tokens / pool_factor`` rows; the first `protected_tokens` rows (CLS,
    prefix) are passed through unpooled."""
    n_tokens = embeddings.shape[0]
    if n_tokens <= protected_tokens + 1:
        return embeddings
    tokens_to_pool = n_tokens - protected_tokens
    num_clusters = max(tokens_to_pool // pool_factor, 1)
    if num_clusters >= tokens_to_pool:
        return embeddings

    to_pool = embeddings[protected_tokens:]
    distances = pdist(to_pool.astype(np.float64), metric="cosine")
    labels = fcluster(
        linkage(distances, method="ward"), t=num_clusters, criterion="maxclust"
    )

    out = np.zeros(
        (protected_tokens + num_clusters, embeddings.shape[1]), embeddings.dtype
    )
    out[:protected_tokens] = embeddings[:protected_tokens]
    for cluster in range(1, num_clusters + 1):
        members = to_pool[labels == cluster]
        if len(members):
            out[protected_tokens + cluster - 1] = members.mean(axis=0)
    return out


def pool_document_embeddings(
    embeddings: Sequence[np.ndarray],
    pool_factor: int,
    protected_tokens: int = 1,
) -> List[np.ndarray]:
    """Pool a batch of per-document embeddings (lib.rs:1632-1643).

    `pool_factor <= 1` is a no-op. Pooled rows are NOT re-normalized (cluster
    means), matching the reference; the index codec re-normalizes on
    decompression.
    """
    if pool_factor <= 1:
        return list(embeddings)
    return [
        pool_embeddings_hierarchical(np.asarray(e), pool_factor, protected_tokens)
        for e in embeddings
    ]
