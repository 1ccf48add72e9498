"""K-means centroid training on the device.

PyTorch counterpart of `nextplaid_tpu.ops.kmeans`. Sampling and sizing are
the JAX package's (and next-plaid's, src/kmeans.rs:261-422), drawn from the
same `np.random.default_rng(seed)` stream, so samples and initial centroids
match the reference bit for bit:
  - sample min(1 + 16*sqrt(120*num_docs), num_docs) documents,
  - K = 2^floor(log2(16 * sqrt(estimated_total_tokens))),
  - at most `max_points_per_centroid` (256) training points per centroid,
  - 4 Lloyd iterations, centroids L2-normalized at the end.

The JAX package splits each Lloyd iteration into assign / sort / blocked
cumulative-sum programs because scatter-adds are slow and large programs
compile slowly on a TPU. Here an iteration is a chunked f32 argmax and an
f32 sum of the points into their clusters, in a fixed order on the card
(`index_put_` with accumulate) so that training is reproducible.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.ops.codec import assign_codes
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class KMeansConfig:
    """Mirrors `ComputeKmeansConfig` (next-plaid src/kmeans.rs:27-43)."""

    num_partitions: Optional[int] = None
    kmeans_niters: int = 4
    max_points_per_centroid: int = 256
    n_samples_kmeans: Optional[int] = None
    seed: int = 42


def n_samples_heuristic(num_documents: int) -> int:
    """min(1 + 16*sqrt(120*N), N) — kmeans.rs:273-276."""
    return min(int(1.0 + 16.0 * math.sqrt(120.0 * num_documents)), num_documents)


def num_partitions_heuristic(estimated_total_tokens: float) -> int:
    """2^floor(log2(16*sqrt(tokens))) — kmeans.rs:304-309."""
    if estimated_total_tokens <= 0:
        return 1
    return 2 ** int(math.floor(math.log2(16.0 * math.sqrt(estimated_total_tokens))))


def assign_chunk_rows(k: int, floor: int = 1024) -> int:
    """Power-of-two row chunk bounding the [chunk, K] f32 score buffer to
    ~256 MB (the JAX package's sizing)."""
    chunk = int(max(floor, min(65536, (256 << 20) // max(k * 4, 1))))
    return 1 << (chunk.bit_length() - 1)


def lloyd(
    data: torch.Tensor,
    init_centroids: torch.Tensor,
    iters: int,
    assign_chunk: int = 65536,
) -> torch.Tensor:
    """Run `iters` Lloyd iterations.

    The assignment runs in f32. (On a TPU the JAX package assigns at its
    DEFAULT precision, which is bf16 there; on the CPU both are f32.)
    Empty clusters keep their previous centroid.

    Args:
      data: [N, d] training points.
      init_centroids: [K, d] on the same device.
      iters: number of iterations.
      assign_chunk: row-chunk size of the assignment, bounding the [chunk, K]
        score buffer.

    Returns:
      [K, d] float32 centroids (not normalized).
    """
    data = data.float()
    centroids = init_centroids.float().clone()
    k = centroids.shape[0]
    for _ in range(iters):
        codes = assign_codes(data, centroids, chunk_rows=assign_chunk).long()
        sums, counts = segment_sums(data, codes, k)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, means, centroids)
    return centroids


def segment_sums(
    rows: torch.Tensor, codes: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster f32 sums [k, d] and counts [k] of `rows` [n, d] under
    `codes` [n] int64 (every code below k).

    Sums in a fixed order on either device, so a build retrained from the
    same sample (a resumed streamed build's reference) writes the same
    bytes. On the card index_add_ sums with atomics, in no fixed order, and
    index_put_'s accumulate sorts the indices first; on the CPU it is the
    other way round: index_put_'s accumulate splits the rows over threads
    and can differ from run to run, index_add_ sums serially in index
    order."""
    sums = torch.zeros((k, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if rows.is_cuda:
        sums.index_put_((codes,), rows, accumulate=True)
    else:
        sums.index_add_(0, codes, rows)
    counts = torch.bincount(codes, minlength=k).to(torch.float32)
    return sums, counts


def prepare_training_sample(
    documents_embeddings: Sequence[np.ndarray],
    config: KMeansConfig = KMeansConfig(),
    flat_device: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
):
    """Sampling/sizing front half of centroid training (next-plaid
    src/kmeans.rs:261-330): sample docs, derive K, cap points per centroid.

    Returns (data_dev [N, d] tensor on `device` ("cuda" when None), k, rng,
    samples_host [N, d]).
    """
    device = resolve_device(device)
    if len(documents_embeddings) == 0:
        raise ValueError("No documents provided")
    num_documents = len(documents_embeddings)

    n_samples = config.n_samples_kmeans or n_samples_heuristic(num_documents)
    n_samples = min(n_samples, num_documents)

    rng = np.random.default_rng(config.seed)
    sampled = rng.permutation(num_documents)[:n_samples]
    samples = np.concatenate(
        [np.asarray(documents_embeddings[i], dtype=np.float32) for i in sampled]
    )
    total_sample_tokens = samples.shape[0]

    if config.num_partitions is not None:
        k = config.num_partitions
    else:
        avg_tokens = total_sample_tokens / n_samples
        k = num_partitions_heuristic(avg_tokens * num_documents)
    k = min(k, total_sample_tokens)
    if k == 0:
        raise ValueError("Cannot compute 0 centroids")

    max_points = k * config.max_points_per_centroid
    subsampled = samples.shape[0] > max_points
    if subsampled:
        keep = rng.permutation(samples.shape[0])[:max_points]
        samples = samples[keep]

    # When sampling selected the whole corpus and a staged device copy
    # exists, train on it directly instead of copying the sample again.
    if (
        flat_device is not None
        and not subsampled
        and n_samples == num_documents
        and flat_device.shape[0] == samples.shape[0]
    ):
        data_dev = flat_device
    else:
        data_dev = torch.from_numpy(samples).to(device)
    return data_dev, k, rng, samples


def compute_kmeans(
    documents_embeddings: Sequence[np.ndarray],
    config: KMeansConfig = KMeansConfig(),
    flat_device: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Train centroids from per-document embedding arrays on `device`
    ("cuda" when None).

    Returns [K, d] float32 L2-normalized centroids.
    """
    data_dev, k, rng, samples_host = prepare_training_sample(
        documents_embeddings, config, flat_device, device
    )
    init_idx = rng.permutation(int(data_dev.shape[0]))[:k]
    init = torch.from_numpy(samples_host[init_idx]).to(data_dev.device)
    centroids = lloyd(
        data_dev,
        init,
        iters=config.kmeans_niters,
        assign_chunk=assign_chunk_rows(k),
    )
    centroids = centroids.cpu().numpy()
    norms = np.linalg.norm(centroids, axis=1, keepdims=True)
    return (centroids / np.maximum(norms, 1e-12)).astype(np.float32)
