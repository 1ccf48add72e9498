"""Two-level residual-quantized (RQ) centroid structure for huge K.

PyTorch counterpart of `nextplaid_tpu.ops.rq`. The factored codebook:

    centroid[c*F + f] = unit(coarse[c] + fine[f])        c < C, f < F, K = C*F

where `coarse` is k-means over tokens and `fine` is k-means over the
coarse-assignment residuals, refined by alternating additive-quantization
steps. Scoring a token against all K centroids decomposes into two small
matmuls and a rank-1 combination:

    token . unit(coarse[c] + fine[f]) = (X[c] + Y[f]) * inv_norm[c, f]

with X = token . coarse, Y = token . fine. The query side of staged search
(stage 1) searches the top-A coarse x top-B fine pairs (`pair_scores_topk`);
training and document assignment score against the materialized flat table
in K blocks with a running max, which is exact.

The flat [K, d] table is written as centroids.npy like a flat build's, so the
codec, storage and every other reader see an ordinary index; only the build's
assignment and stages 1-2 of staged search use the factors (rq_coarse.npy,
rq_fine.npy beside it).

The JAX package loops over row tiles and K blocks with `lax.scan` and sums
segments with sorts and blocked cumulative sums (`_sorted_segment_sum`: TPU
scatter is slow); here the loops are Python loops over tensor slices and
segments are summed by `ops.kmeans.segment_sums`, in a fixed order. Every
product runs in f32 (the entry points turn TF32 off).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.ops import kmeans as kmeans_ops
from nextplaid_tpu_torch.utils.device import DeviceLike

NEG_INF = float("-inf")

# Pairs whose coarse+fine sum is shorter than this are degenerate (their unit
# vector is numerically arbitrary); their inv_norm is 0, so they score -inf
# and are never assigned or probed.
MIN_PAIR_NORM = 0.25

# The suggested opt-in point for memory-bound deployments; "auto" resolves to
# flat at every K, as in the JAX package.
RQ_MIN_K = 65536

# Training-sample cap: C and F are each at most ~1024 centers, so a few
# hundred points per center suffice.
RQ_MAX_TRAIN_TOKENS = 1 << 21

# Row and K-block sizes of the JAX package's programs.
TRAIN_CHUNK = 1 << 14
ASSIGN_CHUNK = 1 << 13
K_BLOCK = 8192


def rq_split(k: int) -> Tuple[int, int]:
    """Balanced C*F factorization of a power-of-two K (C >= F)."""
    if k & (k - 1):
        raise ValueError(f"K={k} must be a power of two")
    log = k.bit_length() - 1
    f = 1 << (log // 2)
    return k // f, f


@dataclass(frozen=True)
class RQCodebook:
    """Factored codebook. `coarse` and `fine` are unnormalized f32 host
    arrays; the flat normalized table and inv_norms are derived."""

    coarse: np.ndarray  # [C, d]
    fine: np.ndarray  # [F, d]

    @property
    def num_coarse(self) -> int:
        return self.coarse.shape[0]

    @property
    def num_fine(self) -> int:
        return self.fine.shape[0]

    @property
    def num_centroids(self) -> int:
        return self.num_coarse * self.num_fine

    def flat_centroids(self) -> np.ndarray:
        """The normalized [C*F, d] table (centroids L2-normalized, as a flat
        build's)."""
        sums = (self.coarse[:, None, :] + self.fine[None, :, :]).reshape(
            -1, self.coarse.shape[1]
        )
        norms = np.linalg.norm(sums, axis=1, keepdims=True)
        return (sums / np.maximum(norms, 1e-12)).astype(np.float32)

    def inv_norms(self) -> np.ndarray:
        """[C, F] f32: 1/||coarse[c]+fine[f]||, 0 for degenerate pairs."""
        sums = self.coarse[:, None, :] + self.fine[None, :, :]
        norms = np.linalg.norm(sums, axis=2)
        inv = np.where(norms >= MIN_PAIR_NORM, 1.0 / np.maximum(norms, 1e-12), 0.0)
        return inv.astype(np.float32)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last axis and their indices, ties towards
    the lower index (as `lax.top_k`; `torch.topk` leaves tie order open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _blocked_argmax(
    rows: torch.Tensor, table: torch.Tensor, bias: torch.Tensor, kblk: int
) -> torch.Tensor:
    """argmax_k (rows @ table.T + bias) [n] int64, one [n, kblk] block of
    scores at a time with a running max. A later block wins only when
    strictly greater and each block's own argmax takes its first maximum, so
    the code is the first maximum over all K, as one argmax would give. The
    tail block is clamped to end at K (it rescores some columns, which a
    strict running max ignores)."""
    k_total = table.shape[0]
    kb = min(kblk, k_total)
    best = torch.full((rows.shape[0],), NEG_INF, dtype=torch.float32, device=rows.device)
    besti = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for start in range(0, k_total, kb):
        ks = min(start, k_total - kb)
        s = rows @ table[ks : ks + kb].T + bias[ks : ks + kb]
        mx, im = torch.max(s, dim=1)
        upd = mx > best
        best = torch.where(upd, mx, best)
        besti = torch.where(upd, im + ks, besti)
    return besti


def _assign_chunked(data: torch.Tensor, centroids: torch.Tensor, chunk: int) -> torch.Tensor:
    """Flat nearest-centroid codes [n] int64 in bounded [chunk, K] score
    tiles."""
    cents_t = centroids.float().T
    out = torch.empty(data.shape[0], dtype=torch.int64, device=data.device)
    for s in range(0, data.shape[0], chunk):
        out[s : s + chunk] = torch.argmax(data[s : s + chunk].float() @ cents_t, dim=1)
    return out


def _refine_rq_step(
    sample: torch.Tensor,
    coarse: torch.Tensor,
    fine: torch.Tensor,
    chunk: int = ASSIGN_CHUNK,
    kblk: int = K_BLOCK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One alternating additive-quantization step: assign every token to its
    L2-nearest pair, argmin ||x - (coarse[c] + fine[f])||^2, exactly, by
    scoring the [C*F, d] sum table with a -||m||^2/2 bias in K blocks; then
    each codebook is the mean of its tokens with the other codebook's part
    subtracted (empty cells keep their vector)."""
    n, d = sample.shape
    c_n, f_n = coarse.shape[0], fine.shape[0]
    m = (coarse[:, None, :] + fine[None, :, :]).reshape(c_n * f_n, d)
    mbias = -0.5 * torch.sum(m * m, dim=1)
    dev = sample.device
    c_sum = torch.zeros((c_n, d), dtype=torch.float32, device=dev)
    c_cnt = torch.zeros(c_n, dtype=torch.float32, device=dev)
    f_sum = torch.zeros((f_n, d), dtype=torch.float32, device=dev)
    f_cnt = torch.zeros(f_n, dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        rows = sample[s : s + chunk].float()
        idx = _blocked_argmax(rows, m, mbias, kblk)
        cc, fc = idx // f_n, idx % f_n
        cs, cn = kmeans_ops.segment_sums(rows - fine[fc], cc, c_n)
        fs, fn = kmeans_ops.segment_sums(rows - coarse[cc], fc, f_n)
        c_sum += cs
        c_cnt += cn
        f_sum += fs
        f_cnt += fn
    new_coarse = torch.where(
        c_cnt[:, None] > 0, c_sum / torch.clamp(c_cnt[:, None], min=1.0), coarse
    )
    new_fine = torch.where(
        f_cnt[:, None] > 0, f_sum / torch.clamp(f_cnt[:, None], min=1.0), fine
    )
    return new_coarse, new_fine


def train_rq(
    sample: torch.Tensor,
    num_coarse: int,
    num_fine: int,
    iters: int = 4,
    refine_iters: int = 4,
    seed: int = 42,
) -> RQCodebook:
    """Train the factored codebook on a token sample (a tensor on the device
    that does the work).

    Bootstrap: coarse = Lloyd over the tokens, fine = Lloyd over the
    coarse-assignment residuals (`ops.kmeans.lloyd`, initial centers drawn by
    `np.random.default_rng(seed)` as the JAX package draws them); then
    `refine_iters` alternating steps (`_refine_rq_step`)."""
    n, _ = sample.shape
    if n < max(num_coarse, num_fine):
        raise ValueError(
            f"sample of {n} tokens too small for C={num_coarse}, F={num_fine}"
        )
    sample = sample.float()
    dev = sample.device
    rng = np.random.default_rng(seed)
    init_c = sample[torch.from_numpy(rng.permutation(n)[:num_coarse]).to(dev)]
    coarse = kmeans_ops.lloyd(sample, init_c, iters=iters, assign_chunk=TRAIN_CHUNK)

    codes = _assign_chunked(sample, coarse, TRAIN_CHUNK)
    residuals = sample - coarse[codes]
    init_f = residuals[torch.from_numpy(rng.permutation(n)[:num_fine]).to(dev)]
    fine = kmeans_ops.lloyd(residuals, init_f, iters=iters, assign_chunk=TRAIN_CHUNK)
    del residuals, codes

    for _ in range(refine_iters):
        coarse, fine = _refine_rq_step(sample, coarse, fine)
    return RQCodebook(
        coarse=coarse.cpu().numpy().astype(np.float32),
        fine=fine.cpu().numpy().astype(np.float32),
    )


def compute_rq_kmeans(
    documents_embeddings: Sequence[np.ndarray],
    config: Optional["kmeans_ops.KMeansConfig"] = None,
    flat_device: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> RQCodebook:
    """RQ counterpart of `ops.kmeans.compute_kmeans`: the same document
    sampling and K heuristic, factored training instead of flat Lloyd, on
    `device` ("cuda" when None). K is rounded down to a power of two."""
    config = config or kmeans_ops.KMeansConfig()
    data_dev, k, _rng, _samples = kmeans_ops.prepare_training_sample(
        documents_embeddings, config, flat_device, device
    )
    if k & (k - 1):
        k = 1 << (k.bit_length() - 1)
    c, f = rq_split(k)
    n = int(data_dev.shape[0])
    if n > RQ_MAX_TRAIN_TOKENS:
        data_dev = data_dev[:: -(-n // RQ_MAX_TRAIN_TOKENS)]
    return train_rq(data_dev, c, f, iters=config.kmeans_niters, seed=config.seed)


def pair_scores_topk(
    x_coarse: torch.Tensor,  # [..., C] scores against coarse
    x_fine: torch.Tensor,  # [..., F] scores against fine
    inv_norms: torch.Tensor,  # [C, F]
    k: int,
    a: int,
    b: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (X[c]+Y[f])*inv_norm[c,f] over all C*F pairs, searched in
    the top-a coarse x top-b fine margin. Degenerate pairs (inv_norm 0) score
    -inf. Returns (scores [..., k] f32, flat cell ids [..., k] int64 =
    c*F + f); ties go to the lower index at each top-k, as `lax.top_k`'s."""
    f = x_fine.shape[-1]
    xa, ia = _top_k(x_coarse, a)
    xb, ib = _top_k(x_fine, b)
    pair = xa[..., :, None] + xb[..., None, :]  # [..., a, b]
    inv = inv_norms[ia[..., :, None], ib[..., None, :]]
    scored = torch.where(inv > 0, pair * inv, torch.full_like(pair, NEG_INF))
    vals, pidx = _top_k(scored.reshape(*scored.shape[:-2], a * b), k)
    ca = torch.gather(ia, -1, torch.div(pidx, b, rounding_mode="floor"))
    fb = torch.gather(ib, -1, pidx % b)
    return vals, ca * f + fb


def assign_codes_rq(
    tokens: torch.Tensor,  # [N, d]
    coarse: torch.Tensor,  # [C, d]
    fine: torch.Tensor,  # [F, d]
    inv_norms: torch.Tensor,  # [C, F]
    a: int = 64,
    b: int = 64,
    chunk: int = ASSIGN_CHUNK,
    kblk: int = K_BLOCK,
) -> torch.Tensor:
    """Exact nearest-centroid assignment over the factored codebook: scores
    against the normalized flat table in `kblk`-column running-max blocks,
    degenerate pairs masked to -inf, `chunk` token rows at a time. `a`/`b`
    are kept for the JAX package's signature; assignment is exact whatever
    they are. Returns [N] int32 codes on the tokens' device."""
    del a, b
    c_n, f_n = coarse.shape[0], fine.shape[0]
    sums = (coarse.float()[:, None, :] + fine.float()[None, :, :]).reshape(c_n * f_n, -1)
    flat = sums / torch.clamp(torch.linalg.norm(sums, dim=1, keepdim=True), min=1e-12)
    kbias = torch.where(
        inv_norms.reshape(-1) > 0,
        torch.zeros((), device=flat.device),
        torch.full((), NEG_INF, device=flat.device),
    )
    out = torch.empty(tokens.shape[0], dtype=torch.int32, device=tokens.device)
    for s in range(0, tokens.shape[0], chunk):
        out[s : s + chunk] = _blocked_argmax(tokens[s : s + chunk].float(), flat, kbias, kblk)
    return out
