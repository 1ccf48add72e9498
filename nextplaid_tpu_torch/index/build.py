"""Index build pipeline: codec training, chunked encoding, IVF, on-disk write.

PyTorch counterpart of `nextplaid_tpu.index.build` (next-plaid
src/index.rs:182-971): centroid training (ops.kmeans), code assignment and
residual quantization (ops.codec) run on the device; the host orchestrates
chunking and writes the reference-compatible NPY + JSON directory.

`centroid_structure="rq"` trains the factored codebook of `ops.rq` and
assigns through it; "auto" and "flat" train flat k-means, as in the JAX
package. The IVF is always built on the host (`build_ivf`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.config import IndexConfig, Metadata
from nextplaid_tpu_torch.ops import codec as codec_ops
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
from nextplaid_tpu_torch.utils.errors import StorageError
from nextplaid_tpu_torch.utils.progress import report as _progress

logger = logging.getLogger(__name__)

# Tokens per residual-quantization tile: bounds the f32 residual and the
# int32 bucket temporaries of `_residual_quantize_tiled`.
QUANTIZE_TILE = 262_144


@dataclass
class CodecArtifacts:
    """Trained codec parameters (next-plaid `PreparedCodecArtifacts`,
    src/index.rs:174-180). `rq` carries the factored codebook of an index
    with the RQ centroid structure: assignment then goes through it."""

    centroids: np.ndarray  # [K, d] f32, L2-normalized
    bucket_cutoffs: np.ndarray  # [2^nbits - 1]
    bucket_weights: np.ndarray  # [2^nbits]
    avg_residual: np.ndarray  # [d] mean |residual| per dim
    cluster_threshold: float  # 0.75-quantile of heldout residual norms
    nbits: int
    rq: Optional[rq_ops.RQCodebook] = None


def assign_with_artifacts(
    emb_device: torch.Tensor, artifacts: CodecArtifacts
) -> torch.Tensor:
    """Nearest-centroid codes [n] int32 for tokens staged on a device,
    through the factored codebook when the artifacts carry one."""
    if artifacts.rq is not None:
        def dev(x):  # a copy: the factors may be read-only memory maps
            return torch.tensor(x, dtype=torch.float32, device=emb_device.device)

        book = artifacts.rq
        return rq_ops.assign_codes_rq(
            emb_device, dev(book.coarse), dev(book.fine), dev(book.inv_norms())
        )
    cents = torch.as_tensor(
        artifacts.centroids, dtype=torch.float32, device=emb_device.device
    )
    chunk = kmeans_ops.assign_chunk_rows(cents.shape[0])
    chunk = min(chunk, 16384)
    return codec_ops.assign_codes(emb_device, cents, chunk_rows=chunk)


def prepare_codec_artifacts(
    documents_embeddings: Sequence[np.ndarray],
    centroids: np.ndarray,
    config: IndexConfig,
    device: torch.device,
    rq: Optional[rq_ops.RQCodebook] = None,
) -> CodecArtifacts:
    """Train bucket cutoffs/weights on a held-out sample.

    next-plaid `prepare_codec_artifacts` (src/index.rs:182-287): sample up
    to 16*sqrt(120*N) docs, hold out 5% of tokens capped at 50K, assign to
    centroids, and derive quantile buckets and the 0.75-quantile cluster
    threshold from the residuals.
    """
    num_documents = len(documents_embeddings)
    if num_documents == 0:
        raise ValueError("No documents provided")
    dim = centroids.shape[1]
    total_embeddings = sum(int(d.shape[0]) for d in documents_embeddings)

    sample_count = max(
        1, min(int(16.0 * np.sqrt(120.0 * num_documents)), num_documents)
    )
    rng = np.random.default_rng(config.seed if config.seed is not None else None)
    indices = rng.permutation(num_documents)[:sample_count]

    heldout_size = int(min(0.05 * total_embeddings, 50_000.0))
    collected: List[np.ndarray] = []
    count = 0
    for idx in indices[::-1]:
        if count >= heldout_size:
            break
        emb = np.asarray(documents_embeddings[idx], np.float32)
        take = min(heldout_size - count, emb.shape[0])
        collected.append(emb[:take])
        count += take
    heldout = (
        np.concatenate(collected)
        if collected
        else np.zeros((0, dim), np.float32)
    )
    if heldout.shape[0] == 0:
        heldout = np.asarray(documents_embeddings[0], np.float32)

    artifacts = CodecArtifacts(
        centroids=np.asarray(centroids, np.float32),
        bucket_cutoffs=np.zeros(0, np.float32),
        bucket_weights=np.zeros(0, np.float32),
        avg_residual=np.zeros(dim, np.float32),
        cluster_threshold=0.0,
        nbits=config.nbits,
        rq=rq,
    )
    return _finish_codec_artifacts(
        artifacts, torch.from_numpy(heldout).to(device), config
    )


def _finish_codec_artifacts(
    artifacts: CodecArtifacts, heldout_dev: torch.Tensor, config: IndexConfig
) -> CodecArtifacts:
    """Shared codec-training tail (in-memory and streamed builds): heldout
    assignment, 0.75-quantile cluster threshold, avg residual, quantile
    buckets (next-plaid src/index.rs:182-287, second half)."""
    centroids = artifacts.centroids
    codes = assign_with_artifacts(heldout_dev, artifacts).cpu().numpy()
    residuals = heldout_dev.cpu().numpy() - centroids[codes]

    norms = np.linalg.norm(residuals, axis=1)
    artifacts.cluster_threshold = (
        float(np.quantile(norms, 0.75)) if norms.size else 0.0
    )
    artifacts.avg_residual = np.mean(np.abs(residuals), axis=0).astype(
        np.float32
    )
    cutoffs, weights = codec_ops.train_codec_buckets(residuals, config.nbits)
    artifacts.bucket_cutoffs = cutoffs
    artifacts.bucket_weights = weights
    return artifacts


@dataclass
class EncodedChunk:
    """One encoded chunk (next-plaid `EncodedIndexChunk`,
    src/index.rs:167-172)."""

    codes: np.ndarray  # [n] i64
    residuals: np.ndarray  # [n, packed_dim] u8
    doclens: List[int]


def _residual_quantize_tiled(
    emb: torch.Tensor,
    codes: torch.Tensor,
    centroids: torch.Tensor,
    cutoffs: torch.Tensor,
    nbits: int,
) -> np.ndarray:
    """Residual + quantize in bounded token tiles -> [n, d*nbits/8] uint8
    on the host."""
    n, d = emb.shape
    out = np.empty((n, d * nbits // 8), np.uint8)
    for s in range(0, n, QUANTIZE_TILE):
        tile = slice(s, s + QUANTIZE_TILE)
        residual = codec_ops.compute_residuals(emb[tile], centroids, codes[tile])
        out[tile] = (
            codec_ops.quantize_residuals(residual, cutoffs, nbits).cpu().numpy()
        )
    return out


def encode_chunk(
    documents_embeddings: Sequence[np.ndarray],
    artifacts: CodecArtifacts,
    batch_device: torch.Tensor,
) -> EncodedChunk:
    """Assign + quantize one batch of documents on the device (next-plaid
    `encode_index_chunk`, src/index.rs:289-371). `batch_device` holds the
    batch's concatenated tokens."""
    doclens = [int(np.asarray(d).shape[0]) for d in documents_embeddings]
    dim = artifacts.centroids.shape[1]
    if sum(doclens) == 0:
        return EncodedChunk(
            codes=np.zeros(0, np.int64),
            residuals=np.zeros((0, dim * artifacts.nbits // 8), np.uint8),
            doclens=doclens,
        )
    device = batch_device.device
    codes_dev = assign_with_artifacts(batch_device, artifacts)
    packed = _residual_quantize_tiled(
        batch_device,
        codes_dev,
        torch.as_tensor(artifacts.centroids, device=device),
        torch.as_tensor(artifacts.bucket_cutoffs, device=device),
        artifacts.nbits,
    )
    return EncodedChunk(
        codes=codes_dev.cpu().numpy().astype(np.int64),
        residuals=packed,
        doclens=doclens,
    )


def build_ivf(
    codes: np.ndarray, doclens: np.ndarray, num_centroids: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Doc-deduplicated posting lists (next-plaid src/index.rs:479-499).

    Returns (ivf_doc_ids [nnz] i64 sorted within each centroid,
    ivf_lengths [K] i32).
    """
    ndocs = len(doclens)
    doc_ids = np.repeat(
        np.arange(ndocs, dtype=np.int64), np.asarray(doclens, np.int64)
    )
    codes = np.asarray(codes, np.int64)
    if codes.size == 0:
        return np.zeros(0, np.int64), np.zeros(num_centroids, np.int32)
    order = np.lexsort((doc_ids, codes))
    sc, sd = codes[order], doc_ids[order]
    keep = np.ones(sc.shape[0], dtype=bool)
    keep[1:] = (sc[1:] != sc[:-1]) | (sd[1:] != sd[:-1])
    uc, ud = sc[keep], sd[keep]
    ivf_lengths = np.bincount(uc, minlength=num_centroids).astype(np.int32)
    return ud, ivf_lengths


def _write_codec(layout: IndexLayout, artifacts: CodecArtifacts) -> None:
    atomic_write_npy(layout.centroids, artifacts.centroids)
    if artifacts.rq is not None:
        atomic_write_npy(layout.rq_coarse, artifacts.rq.coarse)
        atomic_write_npy(layout.rq_fine, artifacts.rq.fine)
    else:
        # A rewrite with flat centroids (a start-from-scratch rebuild of a
        # formerly-RQ index) must not leave stale sidecars behind: factors
        # that disagree with the codes make documents unfindable.
        layout.rq_coarse.unlink(missing_ok=True)
        layout.rq_fine.unlink(missing_ok=True)
    atomic_write_npy(layout.bucket_cutoffs, artifacts.bucket_cutoffs)
    atomic_write_npy(layout.bucket_weights, artifacts.bucket_weights)
    atomic_write_npy(layout.avg_residual, artifacts.avg_residual)
    atomic_write_npy(
        layout.cluster_threshold,
        np.asarray([artifacts.cluster_threshold], np.float32),
    )


def _write_chunk(
    layout: IndexLayout, i: int, chunk: EncodedChunk, offset: int
) -> None:
    atomic_write_json(
        layout.chunk_metadata(i),
        {
            "num_documents": len(chunk.doclens),
            "num_embeddings": len(chunk.codes),
            "embedding_offset": offset,
        },
    )
    atomic_write_json(
        layout.chunk_doclens(i), [int(x) for x in chunk.doclens], indent=0
    )
    atomic_write_npy(layout.chunk_codes(i), chunk.codes.astype(np.int64))
    atomic_write_npy(layout.chunk_residuals(i), chunk.residuals)


def _write_ivf_and_metadata(
    layout: IndexLayout,
    codes: np.ndarray,
    doclens: np.ndarray,
    num_chunks: int,
    config: IndexConfig,
    centroids: np.ndarray,
) -> Metadata:
    num_centroids, dim = centroids.shape
    ivf_data, ivf_lengths = build_ivf(codes, doclens, num_centroids)
    atomic_write_npy(layout.ivf, ivf_data.astype(np.int64))
    atomic_write_npy(layout.ivf_lengths, ivf_lengths.astype(np.int32))

    total = int(codes.shape[0])
    num_documents = int(len(doclens))
    meta = Metadata(
        num_chunks=num_chunks,
        nbits=config.nbits,
        num_partitions=num_centroids,
        num_embeddings=total,
        avg_doclen=total / num_documents if num_documents else 0.0,
        num_documents=num_documents,
        embedding_dim=dim,
        next_plaid_compatible=True,
    )
    atomic_write_json(layout.metadata, meta.to_dict())
    return meta


def write_index(
    chunks: Sequence[EncodedChunk],
    artifacts: CodecArtifacts,
    index_path: str,
    config: IndexConfig,
) -> Metadata:
    """Write all index files (next-plaid `write_index_from_encoded_chunks`,
    src/index.rs:373-528). All writes are atomic tmp+rename."""
    layout = IndexLayout(index_path)
    layout.root.mkdir(parents=True, exist_ok=True)
    _write_codec(layout, artifacts)
    atomic_write_json(
        layout.plan, {"nbits": config.nbits, "num_chunks": len(chunks)}
    )
    offset = 0
    for i, chunk in enumerate(chunks):
        _write_chunk(layout, i, chunk, offset)
        offset += len(chunk.codes)
    codes = (
        np.concatenate([c.codes for c in chunks])
        if chunks
        else np.zeros(0, np.int64)
    )
    doclens = np.asarray([n for c in chunks for n in c.doclens], np.int64)
    return _write_ivf_and_metadata(
        layout, codes, doclens, len(chunks), config, artifacts.centroids
    )


def save_raw_embeddings(
    documents_embeddings: Sequence[np.ndarray], index_path: str
) -> None:
    """Persist raw embeddings for start-from-scratch rebuilds (file names
    as next-plaid's: embeddings.npy + embeddings_lengths.json)."""
    layout = IndexLayout(index_path)
    dim = (
        int(np.asarray(documents_embeddings[0]).shape[1])
        if documents_embeddings
        else 0
    )
    flat = (
        np.concatenate(
            [np.asarray(d, np.float32).reshape(-1, dim) for d in documents_embeddings]
        )
        if documents_embeddings
        else np.zeros((0, dim), np.float32)
    )
    atomic_write_npy(layout.embeddings, flat)
    atomic_write_json(
        layout.embeddings_lengths,
        [int(np.asarray(d).shape[0]) for d in documents_embeddings],
        indent=0,
    )


def create_index(
    documents_embeddings: Sequence[np.ndarray],
    index_path: str,
    config: Optional[IndexConfig] = None,
    centroids: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> Metadata:
    """End-to-end index creation (next-plaid
    `create_index_with_kmeans_files`, src/index.rs:927-971): k-means ->
    codec training -> chunked encode -> write. Runs on `device` ("cuda"
    when None)."""
    config = config or IndexConfig()
    device = resolve_device(device)
    docs = [np.asarray(d, np.float32) for d in documents_embeddings]
    if not docs:
        raise ValueError("No documents provided")

    with file_lock(IndexLayout(index_path).lock):
        # Stage the whole corpus on the device once; k-means (when sampling
        # selects everything) and every encode chunk reuse it.
        dim = docs[0].shape[1]
        dev_flat = torch.from_numpy(
            np.concatenate([d.reshape(-1, dim) for d in docs])
        ).to(device)
        doc_bounds = np.zeros(len(docs) + 1, np.int64)
        np.cumsum([d.shape[0] for d in docs], out=doc_bounds[1:])

        rq_book = None
        if centroids is None:
            _progress("kmeans")
            kcfg = kmeans_ops.KMeansConfig(
                kmeans_niters=config.kmeans_niters,
                max_points_per_centroid=config.max_points_per_centroid,
                n_samples_kmeans=config.n_samples_kmeans,
                seed=config.seed if config.seed is not None else 42,
            )
            # "auto" is flat at every K, as in the JAX package.
            if config.centroid_structure == "rq":
                rq_book = rq_ops.compute_rq_kmeans(
                    docs, kcfg, flat_device=dev_flat, device=device
                )
                centroids = rq_book.flat_centroids()
            else:
                centroids = kmeans_ops.compute_kmeans(
                    docs, kcfg, flat_device=dev_flat, device=device
                )
        _progress("codec")
        artifacts = prepare_codec_artifacts(
            docs, centroids, config, device, rq=rq_book
        )

        chunks: List[EncodedChunk] = []
        for start in range(0, len(docs), config.batch_size):
            end = min(start + config.batch_size, len(docs))
            _progress("encode", processed=start, total=len(docs))
            chunks.append(
                encode_chunk(
                    docs[start:end],
                    artifacts,
                    dev_flat[int(doc_bounds[start]) : int(doc_bounds[end])],
                )
            )
        del dev_flat
        _progress("write")
        meta = write_index(chunks, artifacts, index_path, config)

        if len(docs) <= config.start_from_scratch:
            save_raw_embeddings(docs, index_path)
    return meta


# ---------------------------------------------------------------------------
# Streamed build: the corpus arrives as chunks already on the device
# ---------------------------------------------------------------------------


@dataclass
class DeviceChunk:
    """One corpus chunk staged on a device: [n_tokens, d] f32 token matrix
    plus per-document lengths (sum(doclens) == n_tokens)."""

    tokens: torch.Tensor
    doclens: np.ndarray


def _train_streamed_artifacts(
    sample_tokens: torch.Tensor, est_total_tokens: int, config: IndexConfig
) -> CodecArtifacts:
    """Centroid + codec training for the streamed build: K from the token
    heuristic, flat k-means or the RQ codebook on the device, quantile
    buckets on a held-out slice of at most 50K tokens (of the strided RQ
    training sample, as in the JAX package)."""
    _progress("kmeans")
    k = kmeans_ops.num_partitions_heuristic(float(est_total_tokens))
    seed = config.seed if config.seed is not None else 42
    rq_book = None
    if config.centroid_structure == "rq":
        if k & (k - 1):
            k = 1 << (k.bit_length() - 1)
        c, f = rq_ops.rq_split(k)
        n_s = int(sample_tokens.shape[0])
        if n_s > rq_ops.RQ_MAX_TRAIN_TOKENS:
            sample_tokens = sample_tokens[:: -(-n_s // rq_ops.RQ_MAX_TRAIN_TOKENS)]
        rq_book = rq_ops.train_rq(
            sample_tokens, c, f, iters=config.kmeans_niters, seed=seed
        )
        centroids = rq_book.flat_centroids()
    else:
        rng = np.random.default_rng(seed)
        n_s = int(sample_tokens.shape[0])
        k = min(k, n_s)
        init_idx = torch.from_numpy(rng.permutation(n_s)[:k].astype(np.int64))
        init = sample_tokens[init_idx.to(sample_tokens.device)]
        cents = kmeans_ops.lloyd(
            sample_tokens,
            init,
            iters=config.kmeans_niters,
            assign_chunk=kmeans_ops.assign_chunk_rows(k, floor=512),
        )
        cents = cents.cpu().numpy()
        cents = cents / np.maximum(
            np.linalg.norm(cents, axis=1, keepdims=True), 1e-12
        )
        centroids = cents.astype(np.float32)

    _progress("codec")
    dim = centroids.shape[1]
    artifacts = CodecArtifacts(
        centroids=centroids,
        bucket_cutoffs=np.zeros(0, np.float32),
        bucket_weights=np.zeros(0, np.float32),
        avg_residual=np.zeros(dim, np.float32),
        cluster_threshold=0.0,
        nbits=config.nbits,
        rq=rq_book,
    )
    heldout_n = min(int(sample_tokens.shape[0]), 50_000)
    return _finish_codec_artifacts(artifacts, sample_tokens[:heldout_n], config)


def _streamed_fingerprint_dict(config: IndexConfig, est_total_tokens: int) -> dict:
    """The config facets a resumed streamed build must match. nbits changes
    residual packing width, seed/structure/iters change the trained
    centroids, est_total_tokens drives the K heuristic: reusing artifacts
    trained under any different value silently corrupts the index."""
    return {
        "nbits": int(config.nbits),
        "seed": int(config.seed if config.seed is not None else 42),
        "centroid_structure": str(config.centroid_structure),
        "kmeans_niters": int(config.kmeans_niters),
        "est_total_tokens": int(est_total_tokens),
    }


def _load_streamed_artifacts(
    layout: IndexLayout, config: IndexConfig, est_total_tokens: int
) -> Optional[CodecArtifacts]:
    """Reload trained codec artifacts left by an interrupted streamed build.

    Returns None unless every artifact file exists (training never completed
    or this is a fresh directory), or when no fingerprint file says what
    they were trained under (retraining is the safe path). RQ sidecars, when
    both are present, are reloaded as the codebook. Raises StorageError when
    artifacts were trained under a different config fingerprint, or when
    the sidecars do not factor the centroid table (C*F != K)."""
    needed = (
        layout.centroids,
        layout.bucket_cutoffs,
        layout.bucket_weights,
        layout.avg_residual,
        layout.cluster_threshold,
    )
    if not all(p.exists() for p in needed):
        return None
    if not layout.streamed_fingerprint.exists():
        logger.warning(
            "streamed resume: artifacts present but no fingerprint file; "
            "retraining codec instead of reusing them"
        )
        return None
    stored = load_json(layout.streamed_fingerprint)
    expected = _streamed_fingerprint_dict(config, est_total_tokens)
    if stored != expected:
        raise StorageError(
            "streamed resume refused: on-disk codec artifacts were trained "
            f"under {stored}, current build wants {expected}. Clear the "
            "index directory (or pass the original config) to proceed."
        )

    def f32(path):
        return np.asarray(load_npy(path, mmap=False), np.float32)

    centroids = f32(layout.centroids)
    rq_book = None
    if layout.rq_coarse.exists() and layout.rq_fine.exists():
        rq_book = rq_ops.RQCodebook(
            coarse=f32(layout.rq_coarse), fine=f32(layout.rq_fine)
        )
        if rq_book.num_centroids != centroids.shape[0]:
            raise StorageError(
                "streamed resume refused: the RQ sidecars factor "
                f"{rq_book.num_coarse} x {rq_book.num_fine} centroids, the "
                f"centroid table holds {centroids.shape[0]}. Clear the index "
                "directory to rebuild."
            )
    return CodecArtifacts(
        centroids=centroids,
        bucket_cutoffs=f32(layout.bucket_cutoffs),
        bucket_weights=f32(layout.bucket_weights),
        avg_residual=f32(layout.avg_residual),
        cluster_threshold=float(f32(layout.cluster_threshold)[0]),
        nbits=config.nbits,
        rq=rq_book,
    )


def _streamed_chunk_complete(layout: IndexLayout, i: int, offset: int) -> bool:
    """True when chunk i's four files were fully written by a previous run
    at the same embedding offset (all writes are atomic tmp+rename, so
    existence implies completeness)."""
    meta_p = layout.chunk_metadata(i)
    if not (
        meta_p.exists()
        and layout.chunk_codes(i).exists()
        and layout.chunk_residuals(i).exists()
        and layout.chunk_doclens(i).exists()
    ):
        return False
    try:
        meta = load_json(meta_p)
    except (OSError, ValueError):
        return False
    return int(meta.get("embedding_offset", -1)) == offset


def create_index_streamed(
    chunks: Iterable[DeviceChunk],
    index_path: str,
    config: Optional[IndexConfig] = None,
    sample_tokens: Optional[torch.Tensor] = None,
    est_total_tokens: Optional[int] = None,
    resume: bool = False,
    device: DeviceLike = None,
) -> Metadata:
    """Index a corpus streamed as DeviceChunks; only the packed residuals and
    codes reach the host.

    Args:
      chunks: iterable of DeviceChunk (consumed once).
      sample_tokens: [n, d] tokens for centroid + codec training (required).
      est_total_tokens: drives the K heuristic (next-plaid
        src/kmeans.rs:304-309). Required.
      resume: reuse the codec artifacts and completed chunk files an
        interrupted previous build left in index_path. The caller must
        replay the SAME chunk stream; chunks already written are verified
        by offset and doclens and skipped, not rewritten. A directory
        trained under another config (`streamed_fingerprint.json`) is
        refused with StorageError.
      device: where training and encoding run ("cuda" when None); chunks
        and the sample are moved there.
    """
    config = config or IndexConfig()
    device = resolve_device(device)
    if sample_tokens is None or est_total_tokens is None:
        raise ValueError("streamed build needs sample_tokens and est_total_tokens")

    with file_lock(IndexLayout(index_path).lock):
        layout = IndexLayout(index_path)
        artifacts = (
            _load_streamed_artifacts(layout, config, est_total_tokens)
            if resume
            else None
        )
        resuming = artifacts is not None
        if resuming:
            logger.info(
                "streamed build: resuming with on-disk codec artifacts (K=%d)",
                artifacts.centroids.shape[0],
            )
        else:
            artifacts = _train_streamed_artifacts(
                sample_tokens.to(device, torch.float32), est_total_tokens, config
            )
            # Persist the trained codec and its fingerprint BEFORE the encode
            # loop, so an aborted build can resume without retraining.
            layout.root.mkdir(parents=True, exist_ok=True)
            _write_codec(layout, artifacts)
            atomic_write_json(
                layout.streamed_fingerprint,
                _streamed_fingerprint_dict(config, est_total_tokens),
            )
        cents_dev = torch.as_tensor(artifacts.centroids, device=device)
        cutoffs_dev = torch.as_tensor(artifacts.bucket_cutoffs, device=device)

        all_codes: List[np.ndarray] = []
        all_doclens: List[np.ndarray] = []
        offset = 0
        num_chunks = 0
        for i, chunk in enumerate(chunks):
            _progress("encode", processed=offset)
            doclens = np.asarray(chunk.doclens, np.int64)
            num_chunks = i + 1
            if resuming and _streamed_chunk_complete(layout, i, offset):
                stored = np.asarray(load_json(layout.chunk_doclens(i)), np.int64)
                if not np.array_equal(stored, doclens):
                    raise StorageError(
                        f"streamed resume refused at chunk {i}: stored "
                        f"doclens ({stored.shape[0]} docs, {int(stored.sum())} "
                        f"tokens) differ from the replayed stream "
                        f"({doclens.shape[0]} docs, {int(doclens.sum())} "
                        "tokens): the index dir holds a different corpus. "
                        "Clear it to rebuild."
                    )
                codes = np.asarray(load_npy(layout.chunk_codes(i), mmap=False))
                all_codes.append(codes.astype(np.int64))
                all_doclens.append(stored)
                offset += int(codes.shape[0])
                continue
            # First gap: later chunk files (if any) are re-encoded and
            # atomically overwritten, so the offsets can never diverge from
            # the stream.
            resuming = False
            tokens = chunk.tokens.to(device, torch.float32)
            codes_dev = assign_with_artifacts(tokens, artifacts)
            packed = _residual_quantize_tiled(
                tokens, codes_dev, cents_dev, cutoffs_dev, config.nbits
            )
            encoded = EncodedChunk(
                codes=codes_dev.cpu().numpy().astype(np.int64),
                residuals=packed,
                doclens=[int(x) for x in doclens],
            )
            _write_chunk(layout, i, encoded, offset)
            offset += len(encoded.codes)
            all_codes.append(encoded.codes)
            all_doclens.append(doclens)
        if num_chunks == 0:
            raise ValueError("No chunks provided")

        atomic_write_json(
            layout.plan, {"nbits": config.nbits, "num_chunks": num_chunks}
        )
        _progress("ivf")
        meta = _write_ivf_and_metadata(
            layout,
            np.concatenate(all_codes),
            np.concatenate(all_doclens),
            num_chunks,
            config,
            artifacts.centroids,
        )
        _progress("write")
    return meta


def create_index_from_device(
    tokens: torch.Tensor,
    doclens: Sequence[int],
    index_path: str,
    config: Optional[IndexConfig] = None,
    device: DeviceLike = None,
) -> Metadata:
    """Build an index from a device-resident token matrix
    ([sum(doclens), d] f32, document token rows concatenated), as an
    on-device encoder produces it; the corpus never goes through host
    memory. Heuristics as the JAX package's: K from the token count, k-means
    over the whole matrix, codec trained on a 50K-token held-out slice.
    """
    doclens_np = np.asarray(list(doclens), np.int64)
    total = int(doclens_np.sum())
    if tokens.shape[0] != total:
        raise ValueError(
            f"tokens has {tokens.shape[0]} rows but doclens sum to {total}"
        )
    return create_index_streamed(
        [DeviceChunk(tokens=tokens, doclens=doclens_np)],
        index_path,
        config,
        sample_tokens=tokens,
        est_total_tokens=total,
        device=device,
    )
