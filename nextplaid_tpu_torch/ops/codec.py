"""Residual codec ops: centroid assignment, 2/4-bit residual quantization, decompression.

PyTorch counterpart of `nextplaid_tpu.ops.codec`, with the same bit layout,
so indexes written by either package are byte-identical: each residual
value's bucket index is written LSB-first into an MSB-first bitstream, which
for a whole byte means
``byte = rev(v_0) << (8-nbits) | rev(v_1) << (8-2*nbits) | ...`` where
``rev`` reverses the low `nbits` bits (next-plaid src/codec.rs:154-225).

The JAX package computes the bit reversal and the bucket-weight lookup with
shift/or and select trees, because scalar gathers are slow on a TPU. Here
both are plain lookups into a 2^nbits-entry table.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _bit_reverse_table(nbits: int, device: torch.device) -> torch.Tensor:
    """[2^nbits] uint8 table mapping v to its nbits-bit reversal."""
    table = [
        sum(1 << (nbits - 1 - b) for b in range(nbits) if v & (1 << b))
        for v in range(1 << nbits)
    ]
    return torch.tensor(table, dtype=torch.uint8, device=device)


def _byte_shifts(nbits: int, device: torch.device) -> torch.Tensor:
    """Shift of value k within a byte: 8 - nbits * (k + 1)."""
    return torch.tensor(
        [8 - nbits * (k + 1) for k in range(8 // nbits)],
        dtype=torch.uint8,
        device=device,
    )


def assign_codes(
    embeddings: torch.Tensor, centroids: torch.Tensor, chunk_rows: int = 0
) -> torch.Tensor:
    """Nearest-centroid assignment by inner product, in f32.

    scores = embeddings @ centroids.T -> argmax over centroids (first index
    on ties, as `jnp.argmax`). Non-finite scores lose to any finite score
    (next-plaid `cmp_f32_for_max`, src/codec.rs:23-30).

    Args:
      embeddings: [N, d] float tensor.
      centroids: [K, d] float tensor on the same device.
      chunk_rows: if > 0, score rows in chunks of this size, bounding the
        [chunk, K] score buffer.

    Returns:
      [N] int32 centroid codes.
    """
    cents_t = centroids.float().T
    n = embeddings.shape[0]
    step = chunk_rows if chunk_rows > 0 else max(n, 1)
    out = torch.empty(n, dtype=torch.int32, device=embeddings.device)
    for s in range(0, n, step):
        scores = embeddings[s : s + step].float() @ cents_t
        scores = torch.where(
            torch.isfinite(scores), scores, torch.full_like(scores, -np.inf)
        )
        out[s : s + step] = torch.argmax(scores, dim=1).to(torch.int32)
    return out


def compute_residuals(
    embeddings: torch.Tensor, centroids: torch.Tensor, codes: torch.Tensor
) -> torch.Tensor:
    """residual = embedding - centroid[code]."""
    return embeddings - centroids[codes.long()]


def bucketize(
    residuals: torch.Tensor, bucket_cutoffs: torch.Tensor, nbits: int
) -> torch.Tensor:
    """Bucket index of each residual value: the number of cutoffs strictly
    below it (searchsorted side="left", next-plaid src/codec.rs:386).

    Returns int32 buckets in [0, 2^nbits).
    """
    del nbits
    return torch.searchsorted(
        bucket_cutoffs.contiguous(), residuals.contiguous(), right=False
    ).to(torch.int32)


def pack_buckets(buckets: torch.Tensor, nbits: int) -> torch.Tensor:
    """Pack [..., dim] bucket indices into [..., dim*nbits/8] uint8 bytes."""
    vals_per_byte = 8 // nbits
    *lead, dim = buckets.shape
    if dim % vals_per_byte != 0:
        raise ValueError(f"dim={dim} not a multiple of {vals_per_byte}")
    rev = _bit_reverse_table(nbits, buckets.device)[buckets.long()]
    grouped = rev.reshape(*lead, dim // vals_per_byte, vals_per_byte)
    shifted = grouped << _byte_shifts(nbits, buckets.device)
    # The values occupy disjoint bits, so their sum is their bitwise or.
    return shifted.sum(dim=-1, dtype=torch.int32).to(torch.uint8)


def unpack_buckets(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """Inverse of `pack_buckets`: [..., dim*nbits/8] uint8 -> [..., dim] int32."""
    mask = (1 << nbits) - 1
    segments = (packed.unsqueeze(-1) >> _byte_shifts(nbits, packed.device)) & mask
    buckets = _bit_reverse_table(nbits, packed.device)[segments.long()]
    return buckets.reshape(*packed.shape[:-1], -1).to(torch.int32)


def quantize_residuals(
    residuals: torch.Tensor, bucket_cutoffs: torch.Tensor, nbits: int
) -> torch.Tensor:
    """residuals [..., dim] float -> packed bytes [..., dim*nbits/8] uint8."""
    return pack_buckets(bucketize(residuals, bucket_cutoffs, nbits), nbits)


def decompress_residuals(
    packed: torch.Tensor,
    codes: torch.Tensor,
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    nbits: int,
    normalize: bool = True,
) -> torch.Tensor:
    """Reconstruct embeddings: centroid[code] + bucket_weight[bucket],
    renormalized with a 1e-12 norm floor (next-plaid src/codec.rs:423-470).

    Args:
      packed: [..., dim*nbits/8] uint8.
      codes: [...] integer centroid codes (one per row of `packed`).
      centroids: [K, d].
      bucket_weights: [2^nbits].
    Returns:
      [..., d] float32.
    """
    buckets = unpack_buckets(packed, nbits)
    out = (
        centroids[codes.long()].float()
        + bucket_weights.float()[buckets.long()]
    )
    if normalize:
        norm = torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))
        out = out / torch.clamp(norm, min=1e-12)
    return out


def train_codec_buckets(
    residual_sample: np.ndarray, nbits: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket cutoffs/weights from a residual sample's quantiles.

    Cutoffs at quantiles i/2^nbits for i in 1..2^nbits-1; weights at the
    bucket midpoints (i+0.5)/2^nbits (next-plaid src/index.rs:260-270), with
    numpy's default linear interpolation, as the JAX package computes them.
    """
    n_options = 1 << nbits
    flat = np.asarray(residual_sample, dtype=np.float32).ravel()
    if flat.size == 0:
        return (
            np.zeros(n_options - 1, dtype=np.float32),
            np.zeros(n_options, dtype=np.float32),
        )
    cutoff_q = np.arange(1, n_options) / n_options
    weight_q = (np.arange(n_options) + 0.5) / n_options
    cutoffs = np.quantile(flat, cutoff_q).astype(np.float32)
    weights = np.quantile(flat, weight_q).astype(np.float32)
    return cutoffs, weights
