"""Doc-range-sharded search, k-means and appends over a `Mesh`.

PyTorch counterpart of `nextplaid_tpu.parallel.sharded`. The corpus is cut
into contiguous document ranges, one a shard; the centroids, codec tables
and the query batch are copied to every shard's device. Every shard runs
the single-card pipeline on its own documents and returns its exact local
top-k; the mesh gathers the [S, Q, k] tiles and takes the final top-k, so
the merge loses nothing against one card at equal probe parameters.

  - `ShardedIndex.shard`: the compressed index as one `DeviceIndex` a
    shard, every shard padded to the same shapes (those of the JAX
    package's stacked [S, ...] arrays, which decide budgets and so
    results). `search_batch_sharded` runs the exhaustive scan
    (`exact_search_pipeline`) or the staged pipeline (`search_pipeline`,
    stage 4 as the tile scan, as the JAX shard body runs it) on each shard,
    with `PipelineShapes.derive` on the uniform template.
  - `ShardedGridIndex.shard_grid_only`: the decompressed token grid (bf16,
    or int8 in this package's doc-major layout) a shard, built one shard
    at a time from the chunk files on that shard's device, so the peak is
    one shard. `search_batch_sharded_grid` launches the bf16 or int8 MaxSim
    kernel on every shard, then merges.
  - `lloyd_sharded`: Lloyd's k-means over token shards, the per-shard
    cluster sums and counts summed over the mesh.

Shards on different cards run at once: a search launches every shard's
work and waits once, when the merged result is copied to the host.

Mutations. Both index types append in place (reference incremental
semantics, next-plaid index.rs:1431-1591): `append_batch` writes a batch
encoded against the current centroids into the tail shard's slack (and,
for the grid, spills into empty successor shards), as the JAX package's
`_tail_append_jit` and `_grid_only_chunk_jit` do, but into the shards'
own tensors. The object returned shares those tensors with the one
appended to, which still answers for its own documents (every score path
masks by its own live counts); only the newest object of such a family may
append. `ShardedIndex.append_batch` leaves the IVF stale (staged requests
reroute to the exhaustive scan) until `refresh_ivf` rebuilds the tail
shard's into new tensors, so the object it refreshes keeps its own IVF.
Each returns None where the JAX package does: the batch does not
fit in place, a document is longer than the grid, or the index cannot
grow (an immutable construction, or a mesh over several processes, where
in-place append is a single-controller operation). The caller then
reloads and re-shards from disk, which stays the truth.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.build import build_ivf
from nextplaid_tpu_torch.index.config import (
    Metadata,
    SearchParameters,
    resolve_target_recall,
)
from nextplaid_tpu_torch.index.container import (
    DeviceIndex,
    _AppendTail,
    _round_up,
    load_host_arrays,
    write_grid_rows,
)
from nextplaid_tpu_torch.index.exact import (
    _topk_wide,
    default_doc_tile,
    exact_search_pipeline,
    quantize_queries_int8,
)
from nextplaid_tpu_torch.index.search import (
    NEG_INF,
    PipelineShapes,
    QueryResult,
    _pad_queries,
    search_pipeline,
)
from nextplaid_tpu_torch.ops.codec import assign_codes
from nextplaid_tpu_torch.ops.kmeans import assign_chunk_rows, segment_sums
from nextplaid_tpu_torch.ops.maxsim_kernel import (
    maxsim_grid_scores,
    maxsim_grid_scores_int8i,
)
from nextplaid_tpu_torch.parallel.mesh import Mesh, make_mesh
from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json, load_npy
from nextplaid_tpu_torch.utils.errors import StorageError, UpdateError

logger = logging.getLogger(__name__)

# Grid rows are built, appended and masked in tiles of this many docs (the
# JAX package's int8 group).
GRID_TILE = 128


def _on_devices(devices: Sequence[torch.device], make) -> Dict[torch.device, object]:
    """`make(device)` once for each distinct device."""
    return {d: make(d) for d in dict.fromkeys(devices)}


def _require_newest(tail: _AppendTail, num_documents: int) -> None:
    """Raise unless this object is the newest of the family that shares its
    tensors: an older one would write over rows a successor serves."""
    if tail.n_docs is not None and tail.n_docs != num_documents:
        raise UpdateError(
            f"this index ({num_documents} docs) shares its tensors with a "
            f"successor of {tail.n_docs} docs made by append_batch; append to "
            "the newest index"
        )


def _local_tiles(
    scores: torch.Tensor, ids: torch.Tensor, doc_base: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A shard's local top-k with its ids made global (-1 where empty)."""
    ids = torch.where(torch.isfinite(scores), ids.to(torch.int64) + doc_base, -1)
    return scores, ids


def merge_tiles(
    mesh: Mesh, tiles: List[Tuple[torch.Tensor, torch.Tensor]], top_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather every shard's [Q, k] (scores, ids) tiles and take the final
    top-k of each query over all of them. Returns (ids [Q, top_k] with -1
    for empty slots, scores)."""
    all_s = mesh.all_gather([s for s, _ in tiles])  # [S, Q, k]
    all_i = mesh.all_gather([i for _, i in tiles])
    q_n = all_s.shape[1]
    merged_s = all_s.transpose(0, 1).reshape(q_n, -1)
    merged_i = all_i.transpose(0, 1).reshape(q_n, -1)
    final_s, slots = torch.topk(merged_s, min(top_k, merged_s.shape[1]), dim=1)
    final_i = torch.gather(merged_i, 1, slots)
    return torch.where(torch.isfinite(final_s), final_i, -1), final_s


def _results(ids: torch.Tensor, scores: torch.Tensor, n: int) -> List[QueryResult]:
    """QueryResults of the first `n` rows (the one wait for the device)."""
    ids, scores = ids[:n].cpu().numpy(), scores[:n].cpu().numpy()
    out = []
    for i in range(n):
        valid = ids[i] >= 0
        out.append(QueryResult(
            query_id=i,
            passage_ids=[int(x) for x in ids[i][valid]],
            scores=[float(s) for s in scores[i][valid]],
        ))
    return out


# ---------------------------------------------------------------------------
# Host snapshot
# ---------------------------------------------------------------------------


@dataclass
class HostIndexData:
    """Flat host-side arrays of an index (the sharding input)."""

    centroids: np.ndarray
    codes: np.ndarray
    residuals: np.ndarray
    doclens: np.ndarray
    doc_offsets: np.ndarray
    bucket_cutoffs: np.ndarray
    bucket_weights: np.ndarray
    avg_residual: np.ndarray
    nbits: int

    @classmethod
    def from_device_index(cls, index: DeviceIndex) -> "HostIndexData":
        nd, nv = index.num_documents, index.num_embeddings

        def host(t):
            return t.cpu().numpy()

        return cls(
            centroids=host(index.centroids),
            codes=host(index.codes)[:nv],
            residuals=host(index.residuals)[:nv],
            doclens=host(index.doclens)[:nd],
            doc_offsets=host(index.doc_offsets)[: nd + 1],
            bucket_cutoffs=host(index.bucket_cutoffs),
            bucket_weights=host(index.bucket_weights),
            avg_residual=host(index.avg_residual),
            nbits=index.nbits,
        )

    @classmethod
    def load(cls, index_path: str) -> "HostIndexData":
        """Read an index directory straight into host arrays
        (`load_host_arrays`), never staging the corpus on one device: a
        corpus served sharded is one that need not fit a single card."""
        h = load_host_arrays(index_path)
        doclens = h["doclens"]
        doc_offsets = np.zeros(len(doclens) + 1, np.int32)
        np.cumsum(doclens, out=doc_offsets[1:])
        return cls(
            centroids=h["centroids"],
            codes=h["codes"],
            residuals=h["residuals"],
            doclens=doclens,
            doc_offsets=doc_offsets,
            bucket_cutoffs=h["bucket_cutoffs"],
            bucket_weights=h["bucket_weights"],
            avg_residual=h["avg_residual"],
            nbits=h["meta"].nbits,
        )


# ---------------------------------------------------------------------------
# Sharded compressed index (exhaustive and staged search)
# ---------------------------------------------------------------------------


@dataclass
class ShardedIndex:
    """A doc-range-sharded compressed index over a mesh.

    `shards` holds this process's shards, each a `DeviceIndex` on its mesh
    device with the uniform padded shapes, its live counts and the uniform
    static fields (`static`: nbits, max_doclen, max_posting_len). The
    host arrays cover every shard of the mesh."""

    mesh: Mesh
    shards: List[DeviceIndex]
    doc_base: np.ndarray  # [S] i64: global id of each shard's first doc
    shard_docs: np.ndarray  # [S] i64: live docs per shard
    shard_embs: np.ndarray  # [S] i64: live tokens per shard
    shard_capacity: int  # docs a shard takes at the split (before appends)
    num_documents: int
    max_shard_embeddings: int
    static: dict
    # Set by append_batch: the tail shard's IVF lacks the appended docs, so
    # staged requests reroute to the exhaustive scan until refresh_ivf.
    ivf_stale: bool = False
    # Most live docs on any shard (appends grow the tail past the split).
    max_shard_docs: int = 0
    append_tail: _AppendTail = field(default_factory=_AppendTail, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @classmethod
    def shard(
        cls, index: HostIndexData, mesh: Mesh, capacity_factor: float = 1.0
    ) -> "ShardedIndex":
        """Split host arrays into contiguous doc ranges, one a shard.

        capacity_factor > 1 reserves doc, token and posting slack in every
        shard, so that `append_batch` grows the corpus in place (tail
        shard) instead of a reload and re-shard. The last doc slot of every
        shard stays empty: it is the IVF's padding sentinel."""
        n = mesh.size
        nd = len(index.doclens)
        cap = max(-(-nd // n), 1)
        offsets = np.asarray(index.doc_offsets, np.int64)
        bounds = [(min(s * cap, nd), min((s + 1) * cap, nd)) for s in range(n)]
        max_shard_tokens = max(int(offsets[hi] - offsets[lo]) for lo, hi in bounds)
        grows = capacity_factor > 1.0
        doc_capacity = int(np.ceil(cap * capacity_factor)) + 1 if grows else 0
        token_capacity = int(np.ceil(max_shard_tokens * capacity_factor)) if grows else 0

        # Every shard's host arrays (the uniform shapes need them all), but
        # only this process's shards on their devices.
        parts = []
        for lo, hi in bounds:
            doclens_s = np.zeros(cap, np.int32)
            doclens_s[: hi - lo] = index.doclens[lo:hi]
            tok = slice(int(offsets[lo]), int(offsets[hi]))
            ivf_ids, ivf_lengths = build_ivf(
                index.codes[tok], doclens_s, index.centroids.shape[0]
            )
            parts.append((doclens_s, tok, ivf_ids, ivf_lengths))
        # The stacked widths of the JAX package (every shard at the largest
        # shard's padded token and posting counts).
        token_width = max(_round_up(max(t.stop - t.start, token_capacity, 1), 128)
                          for _, t, _, _ in parts)
        ivf_width = max(_round_up(max(len(ids), token_capacity, 1), 128)
                        for _, _, ids, _ in parts)
        static = dict(
            nbits=index.nbits,
            max_doclen=max(int(p[0].max()) for p in parts),
            max_posting_len=max(max(int(p[3].max()) for p in parts), 1),
        )
        shard_docs = np.asarray([hi - lo for lo, hi in bounds], np.int64)
        shard_embs = np.asarray([t.stop - t.start for _, t, _, _ in parts], np.int64)
        shards = []
        for s, dev in zip(mesh.local_shards, mesh.devices):
            doclens_s, tok, ivf_ids, ivf_lengths = parts[s]
            built = DeviceIndex.from_host(
                centroids=index.centroids,
                codes=index.codes[tok],
                residuals=index.residuals[tok],
                doclens=doclens_s,
                ivf_lengths=ivf_lengths,
                ivf_doc_ids=ivf_ids,
                bucket_cutoffs=index.bucket_cutoffs,
                bucket_weights=index.bucket_weights,
                avg_residual=index.avg_residual,
                nbits=index.nbits,
                doc_capacity=doc_capacity,
                token_capacity=token_width,
                ivf_capacity=ivf_width,
                device=dev,
            )
            shards.append(dataclasses.replace(
                built, n_docs=int(shard_docs[s]), n_emb=int(shard_embs[s]),
                posting_mass_prefix=(), **static,
            ))
        return cls(
            mesh=mesh,
            shards=shards,
            doc_base=np.asarray([lo for lo, _ in bounds], np.int64),
            shard_docs=shard_docs,
            shard_embs=shard_embs,
            shard_capacity=cap,
            num_documents=nd,
            max_shard_embeddings=int(shard_embs.max()),
            static=static,
            max_shard_docs=int(shard_docs.max()) if nd else 0,
        )

    def local_index_template(self) -> DeviceIndex:
        """A shard with the uniform shapes and the largest live counts
        (appends grow the tail past the split): what `PipelineShapes.derive`
        plans a sharded search from."""
        return dataclasses.replace(
            self.shards[0],
            n_docs=max(self.shard_capacity, self.max_shard_docs),
            n_emb=self.max_shard_embeddings,
        )

    def _advanced(self, **changes) -> "ShardedIndex":
        """A successor sharing this index's tensors, its shard views set to
        the new live counts and static fields."""
        out = dataclasses.replace(self, **changes)
        out.shards = [
            dataclasses.replace(
                t, n_docs=int(out.shard_docs[s]), n_emb=int(out.shard_embs[s]), **out.static
            )
            for s, t in zip(self.mesh.local_shards, self.shards)
        ]
        return out

    def append_batch(
        self, codes: np.ndarray, residuals: np.ndarray, doclens: np.ndarray
    ) -> Optional["ShardedIndex"]:
        """Append encoded documents into the tail shard's slack (shard with
        `capacity_factor` > 1), in place. Marks the IVF stale. Returns None
        when the batch does not fit in place, or on a mesh over several
        processes: the caller reloads and re-shards."""
        doclens = np.asarray(doclens, np.int64)
        b, t = int(doclens.shape[0]), int(doclens.sum())
        if b == 0:
            return self
        codes = np.asarray(codes, np.int32)
        residuals = np.asarray(residuals, np.uint8)
        if codes.shape[0] != t or residuals.shape[0] != t:
            raise ValueError(
                f"batch shapes disagree: {codes.shape[0]} codes / "
                f"{residuals.shape[0]} residuals vs doclens sum {t}"
            )
        if self.mesh.world_size > 1:
            return None
        _require_newest(self.append_tail, self.num_documents)
        tail = self.n_shards - 1
        shard = self.shards[tail]
        docs_tail, embs_tail = int(self.shard_docs[tail]), int(self.shard_embs[tail])
        nd_pad, tok_pad = shard.num_docs_padded, shard.codes.shape[0]
        # The last doc slot stays empty: it is the IVF padding sentinel.
        if docs_tail + b > nd_pad - 1 or embs_tail + t > tok_pad:
            return None
        dev = shard.device
        shard.codes[embs_tail : embs_tail + t] = torch.from_numpy(codes).to(dev)
        shard.residuals[embs_tail : embs_tail + t] = torch.from_numpy(residuals).to(dev)
        lens = torch.from_numpy(doclens.astype(np.int32)).to(dev)
        shard.doclens[docs_tail : docs_tail + b] = lens
        # Past the live docs the offsets repeat the total, as `from_host`
        # pads them.
        shard.doc_offsets[docs_tail + 1 : docs_tail + 1 + b] = embs_tail + torch.cumsum(
            lens, 0, dtype=torch.int32
        )
        shard.doc_offsets[docs_tail + 1 + b :] = embs_tail + t
        shard_docs, shard_embs = self.shard_docs.copy(), self.shard_embs.copy()
        shard_docs[tail] += b
        shard_embs[tail] += t
        out = self._advanced(
            shard_docs=shard_docs,
            shard_embs=shard_embs,
            num_documents=self.num_documents + b,
            max_shard_embeddings=max(self.max_shard_embeddings, int(shard_embs[tail])),
            static=dict(self.static, max_doclen=max(self.static["max_doclen"], int(doclens.max()))),
            ivf_stale=True,
            max_shard_docs=max(self.max_shard_docs, self.shard_capacity, docs_tail + b),
        )
        out.shards[tail].mark_ivf_stale()
        self.append_tail.n_docs = out.num_documents
        return out

    def refresh_ivf(self) -> Optional["ShardedIndex"]:
        """Rebuild the tail shard's IVF from its appended codes into new
        tensors of the reserved width, and clear the stale flag (one
        shard's codes cross to the host).
        Returns None when the grown posting set exceeds the reserved IVF
        slack: the caller re-shards."""
        if not self.ivf_stale:
            return self
        tail = self.n_shards - 1
        shard = self.shards[tail]
        t = int(self.shard_embs[tail])
        ivf_ids, ivf_lengths = build_ivf(
            shard.codes[:t].cpu().numpy(), shard.doclens.cpu().numpy(), shard.num_centroids
        )
        width, nnz = shard.ivf_doc_ids.shape[0], int(ivf_ids.shape[0])
        if nnz > width:
            return None
        ivf_p = np.full(width, shard.num_docs_padded - 1, np.int32)
        ivf_p[:nnz] = ivf_ids
        offsets = np.zeros(shard.num_centroids + 1, np.int64)
        np.cumsum(ivf_lengths, out=offsets[1:])
        longest = int(ivf_lengths.max()) if len(ivf_lengths) else 0
        static = dict(self.static, max_posting_len=max(self.static["max_posting_len"], longest))
        out = self._advanced(static=static, ivf_stale=False)
        # New IVF tensors: this object, still served until its successor
        # replaces it, keeps reading its own.
        out.shards[tail] = dataclasses.replace(
            out.shards[tail],
            ivf_doc_ids=torch.from_numpy(ivf_p).to(shard.device),
            ivf_offsets=torch.from_numpy(offsets.astype(np.int32)).to(shard.device),
            ivf_stale=False,
        )
        return out


def _shard_tiles(
    sindex: ShardedIndex,
    queries: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]],
    subset_masks: Optional[List[torch.Tensor]],
    params: SearchParameters,
    shapes: PipelineShapes,
    mode: str,
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], List[torch.Tensor]]:
    """Each local shard's (scores, global ids) top-k tiles and its posting
    overflow, launched one shard after another with no wait."""
    tiles, overflow = [], []
    for i, (s, shard) in enumerate(zip(sindex.mesh.local_shards, sindex.shards)):
        q, m = queries[shard.device]
        subset = None if subset_masks is None else subset_masks[i]
        if mode == "exact":
            ids, scores = exact_search_pipeline(
                shard, q, m, subset, top_k=params.top_k,
                doc_tile=default_doc_tile(q.shape[0], q.shape[1], shard.token_axis()),
                precision=shapes.stage1_precision,
            )
            over = torch.zeros((), dtype=torch.int64, device=shard.device)
        else:
            ids, scores, over = search_pipeline(shard, q, m, subset, shapes)
            over = over[0]
        tiles.append(_local_tiles(scores, ids, int(sindex.doc_base[s])))
        overflow.append(over)
    return tiles, overflow


def search_batch_sharded(
    sindex: ShardedIndex,
    queries: Sequence[np.ndarray],
    params: Optional[SearchParameters] = None,
    subset: Optional[Sequence[int]] = None,
) -> List[QueryResult]:
    """Doc-sharded batched search over the mesh: mode "exact" scans every
    shard, "staged" runs the staged pipeline on every shard, "auto" picks
    by the largest shard's token count. A stale IVF reroutes staged
    requests to the scan. Posting-budget overflow is summed over the shards
    and logged; the merged result stands (the JAX package's sharded search
    has no exhaustive fallback)."""
    params = params or SearchParameters()
    if not queries:
        return []
    if params.target_recall is not None:
        params = resolve_target_recall(params)
    if sindex.ivf_stale and params.mode != "exact":
        logger.warning(
            "sharded IVF is stale after append_batch; routing to exhaustive "
            "search (call ShardedIndex.refresh_ivf to restore staged mode)"
        )
        params = dataclasses.replace(params, mode="exact")
    n = len(queries)
    q_arr, q_mask = _pad_queries(queries, sindex.dim)
    template = sindex.local_index_template()
    # Stage 4 as the tile scan: the JAX shard body's route.
    shapes = dataclasses.replace(
        PipelineShapes.derive(template, params, q_arr.shape[0], q_arr.shape[1]),
        rerank_kernel=False,
    )
    mode = params.mode
    if mode == "auto":
        mode = "exact" if template.num_embeddings <= params.exact_max_embeddings else "staged"

    subset_masks = None
    if subset is not None:
        # Global ids -> (shard, slot) through the real boundaries: appends
        # grow the tail shard past the split.
        nd_pad = template.num_docs_padded
        ids = np.asarray(list(subset), np.int64)
        ids = ids[(ids >= 0) & (ids < sindex.num_documents)]
        shard_of = np.searchsorted(sindex.doc_base, ids, side="right") - 1
        local = ids - sindex.doc_base[shard_of]
        subset_masks = []
        for s, shard in zip(sindex.mesh.local_shards, sindex.shards):
            mask = np.zeros(nd_pad, bool)
            mask[local[(shard_of == s) & (local < nd_pad)]] = True
            subset_masks.append(torch.from_numpy(mask).to(shard.device))

    q_t, m_t = torch.from_numpy(q_arr), torch.from_numpy(q_mask)
    on_dev = _on_devices(sindex.mesh.devices, lambda d: (q_t.to(d), m_t.to(d)))
    tiles, overflow = _shard_tiles(sindex, on_dev, subset_masks, params, shapes, mode)
    ids, scores = merge_tiles(sindex.mesh, tiles, params.top_k)
    results = _results(ids, scores, n)
    if mode == "staged":
        dropped = int(sindex.mesh.sum(overflow).item())
        if dropped:
            logger.warning(
                "sharded posting-budget overflow: %d posting entries dropped over "
                "the shards (posting_budget=%d); raise SearchParameters.posting_budget",
                dropped, shapes.posting_budget,
            )
    return results


# ---------------------------------------------------------------------------
# Sharded k-means
# ---------------------------------------------------------------------------


def lloyd_sharded(
    data,
    init_centroids,
    iters: int,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Lloyd's k-means with the training points split over the mesh.

    Each shard assigns its points (the f32 chunked argmax of `lloyd`) and
    sums them into their clusters (`segment_sums`); the summed [K, d] sums
    and [K] counts over the mesh give the update, and an empty cluster
    keeps its centroid. Returns the L2-normalized [K, d] f32 centroids on
    the host. `data` [N, d] and `init_centroids` [K, d] are numpy arrays or
    tensors."""
    mesh = mesh or make_mesh()
    data = torch.as_tensor(data)
    n = data.shape[0]
    k = int(init_centroids.shape[0])
    per = _round_up(max(-(-n // mesh.size), 1), 8)
    chunk = assign_chunk_rows(k)
    local = [
        data[min(s * per, n) : min((s + 1) * per, n)].to(dev, torch.float32)
        for s, dev in zip(mesh.local_shards, mesh.devices)
    ]
    head = mesh.devices[0]
    centroids = torch.as_tensor(init_centroids).to(head, torch.float32)
    for _ in range(iters):
        on_dev = _on_devices(mesh.devices, centroids.to)
        sums, counts = [], []
        for x, dev in zip(local, mesh.devices):
            codes = assign_codes(x, on_dev[dev], chunk_rows=chunk).long()
            s, c = segment_sums(x, codes, k)
            sums.append(s)
            counts.append(c)
        total, count = mesh.sum(sums), mesh.sum(counts)
        means = total / torch.clamp(count, min=1.0)[:, None]
        centroids = torch.where(count[:, None] > 0, means, centroids)
    out = centroids.cpu().numpy()
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norms, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# Sharded grid-only exact serving
# ---------------------------------------------------------------------------


@dataclass
class ShardedGridIndex:
    """Doc-range-sharded pinned token grids for exact serving over a mesh.

    Each of this process's shards holds the decompressed grid of its doc
    range on its device: bf16 [rows, Td, d], or int8 [rows, Td, d] with
    bf16 scales [rows, Td] in this package's doc-major layout (the one
    `csrc/maxsim_int8.cu` reads; the JAX package's int8 shards are
    token-interleaved [rows/128, d, 128*Td]), and doclens [rows] i32 (0 for
    empty rows). Rows are uniform over the shards and leave slack that
    `append_batch` fills. The host arrays give every shard's real
    boundaries."""

    mesh: Mesh
    grids: List[torch.Tensor]
    scales: List[Optional[torch.Tensor]]
    doclens: List[torch.Tensor]
    num_documents: int
    num_embeddings: int
    doc_base_host: np.ndarray  # [S] i64: global id of each shard's first doc
    shard_docs_host: np.ndarray  # [S] i64: live docs per shard
    # What in-place appends decompress with. None / 0: an immutable
    # construction (append_batch declines; the caller reloads).
    centroids_host: Optional[np.ndarray] = None
    weights_host: Optional[np.ndarray] = None
    nbits: int = 0
    # Codec tables on each device, kept across appends.
    dev_consts: dict = field(default_factory=dict, repr=False, compare=False)
    append_tail: _AppendTail = field(default_factory=_AppendTail, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def is_int8(self) -> bool:
        return self.scales[0] is not None

    @property
    def dim(self) -> int:
        return self.grids[0].shape[2]

    @property
    def rows(self) -> int:
        """Doc rows of every shard."""
        return self.grids[0].shape[0]

    @property
    def grid_td(self) -> int:
        """Token axis of the grids."""
        return self.grids[0].shape[1]

    def _consts(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        if device not in self.dev_consts:
            self.dev_consts[device] = (
                torch.tensor(self.centroids_host, device=device),
                torch.tensor(self.weights_host, device=device),
            )
        return self.dev_consts[device]

    @classmethod
    def shard_grid_only(
        cls, index_path: str, mesh: Mesh, dtype: str = "int8"
    ) -> "ShardedGridIndex":
        """Load an on-disk index as doc-range grid shards over the mesh,
        one shard at a time: each shard's docs stream from the chunk files
        that hold them through decompress (+ quantize for int8) into a
        grid on the shard's own device, so the peak is one shard and one
        chunk, nowhere the whole grid."""
        if dtype not in ("bf16", "int8"):
            raise StorageError(f"grid dtype must be bf16|int8: {dtype}")
        layout = IndexLayout(index_path)
        meta = Metadata.from_dict(load_json(layout.metadata))
        centroids_host = np.asarray(load_npy(layout.centroids), np.float32)
        weights_host = np.asarray(load_npy(layout.bucket_weights), np.float32)
        dim = centroids_host.shape[1]
        doclens_list = [
            np.asarray(load_json(layout.chunk_doclens(i)), np.int64)
            for i in range(meta.num_chunks)
        ]
        doclens_all = (
            np.concatenate(doclens_list) if doclens_list else np.zeros(0, np.int64)
        ).astype(np.int32)
        chunk_starts = np.concatenate([[0], np.cumsum([len(d) for d in doclens_list])])
        nd = int(doclens_all.shape[0])
        max_doclen = int(doclens_all.max()) if nd else 0
        mult = 32 if dtype == "int8" else 8  # container._grid_td_for
        td = max(_round_up(max(max_doclen, 1), mult), mult)
        n = mesh.size
        cap = max(-(-nd // n), 1)
        # The JAX package's rows: the split rounded to tiles, plus one
        # chunk's docs and a tile of slack for appends.
        max_chunk_docs = max((len(d) for d in doclens_list), default=1)
        cdoc_pad = max(_round_up(min(max_chunk_docs, cap), GRID_TILE), GRID_TILE)
        rows = max(_round_up(cap, GRID_TILE), GRID_TILE) + cdoc_pad + GRID_TILE
        bounds = [(min(s * cap, nd), min((s + 1) * cap, nd)) for s in range(n)]

        sg = cls(
            mesh=mesh, grids=[], scales=[], doclens=[],
            num_documents=nd, num_embeddings=int(doclens_all.sum()),
            doc_base_host=np.asarray([lo for lo, _ in bounds], np.int64),
            shard_docs_host=np.asarray([hi - lo for lo, hi in bounds], np.int64),
            centroids_host=centroids_host, weights_host=weights_host, nbits=meta.nbits,
        )
        for s, dev in zip(mesh.local_shards, mesh.devices):
            lo, hi = bounds[s]
            grid_dtype = torch.int8 if dtype == "int8" else torch.bfloat16
            grid = torch.zeros((rows, td, dim), dtype=grid_dtype, device=dev)
            scales = (
                torch.zeros((rows, td), dtype=torch.bfloat16, device=dev)
                if dtype == "int8" else None
            )
            cent, wts = sg._consts(dev)
            row = 0
            for i in range(meta.num_chunks):
                c_lo, c_hi = int(chunk_starts[i]), int(chunk_starts[i + 1])
                a, b = max(lo, c_lo), min(hi, c_hi)
                if a >= b:
                    continue
                dl = doclens_list[i]
                offs = np.zeros(len(dl), np.int64)
                np.cumsum(dl[:-1], out=offs[1:])
                sel = slice(a - c_lo, b - c_lo)
                write_grid_rows(
                    grid, scales,
                    torch.tensor(np.asarray(load_npy(layout.chunk_codes(i)), np.int32), device=dev),
                    torch.tensor(np.asarray(load_npy(layout.chunk_residuals(i))), device=dev),
                    torch.from_numpy(offs[sel]).to(dev), torch.from_numpy(dl[sel]).to(dev),
                    row, cent, wts, meta.nbits,
                )
                row += b - a
            lens = torch.zeros(rows, dtype=torch.int32)
            lens[: hi - lo] = torch.from_numpy(doclens_all[lo:hi])
            sg.grids.append(grid)
            sg.scales.append(scales)
            sg.doclens.append(lens.to(dev))
        return sg

    def append_batch(
        self, codes: np.ndarray, residuals: np.ndarray, doclens: np.ndarray
    ) -> Optional["ShardedGridIndex"]:
        """Append encoded documents in place: O(batch) decompress into the
        tail (last non-empty) shard's row slack, spilling into empty
        successor shards when its rows run out. `codes` / `residuals` /
        `doclens` are a batch encoded against the current centroids (the
        buffer-mode update's `info_out["encoded"]`); global ids continue
        the on-disk order.

        Returns the advanced index (sharing every tensor with this one), or
        None when the append cannot be done in place: an immutable
        construction, a doc longer than the grid's token axis, a mesh over
        several processes, or the rows exhausted."""
        if (
            self.centroids_host is None
            or self.weights_host is None
            or self.nbits <= 0
            or self.mesh.world_size > 1
        ):
            return None
        doclens = np.asarray(doclens, np.int64)
        nb = int(doclens.shape[0])
        if nb == 0:
            return self
        btok = int(doclens.sum())
        codes, residuals = np.asarray(codes), np.asarray(residuals)
        if codes.shape[0] != btok or residuals.shape[0] != btok:
            raise ValueError(
                f"batch shapes disagree: {codes.shape[0]} codes / "
                f"{residuals.shape[0]} residuals vs doclens sum {btok}"
            )
        if int(doclens.max()) > self.grid_td:
            return None  # longer than the grid's token axis: reload
        if residuals.shape[1] * 8 != self.dim * self.nbits:
            raise ValueError(
                f"residual width {residuals.shape[1]} does not match "
                f"dim={self.dim} nbits={self.nbits}"
            )
        _require_newest(self.append_tail, self.num_documents)

        # Plan (shard, lo, hi) sub-batches as the JAX package does: the tail
        # shard first, then empty successors. A shard takes whole tiles of
        # its free rows; an int8 shard keeps one tile back (the JAX
        # package's token-interleaved group rewrite needs it; kept so that
        # shard boundaries equal the JAX package's).
        doc_base = self.doc_base_host.copy()
        shard_docs = self.shard_docs_host.copy()
        nonzero = np.nonzero(shard_docs)[0]
        s = int(nonzero[-1]) if nonzero.size else 0
        plan = []
        lo = 0
        while lo < nb:
            if s >= self.n_shards:
                return None  # every shard's rows exhausted: re-shard
            free = self.rows - int(shard_docs[s]) - (GRID_TILE if self.is_int8 else 0)
            take = min(nb - lo, (free // GRID_TILE) * GRID_TILE)
            if take > 0:
                plan.append((s, lo, lo + take))
                lo += take
            s += 1

        tok_offsets = np.zeros(nb + 1, np.int64)
        np.cumsum(doclens, out=tok_offsets[1:])
        for s, a, b in plan:
            row0 = int(shard_docs[s])
            if s in self.mesh.local_shards:
                i = s - self.mesh.local_shards.start
                dev = self.grids[i].device
                cent, wts = self._consts(dev)
                tok = slice(int(tok_offsets[a]), int(tok_offsets[b]))
                lens = torch.from_numpy(doclens[a:b]).to(dev)
                write_grid_rows(
                    self.grids[i], self.scales[i],
                    torch.from_numpy(codes[tok].astype(np.int32)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(residuals[tok], np.uint8)).to(dev),
                    torch.from_numpy(tok_offsets[a:b] - tok_offsets[a]).to(dev), lens,
                    row0, cent, wts, self.nbits,
                )
                self.doclens[i][row0 : row0 + b - a] = lens.to(torch.int32)
            if shard_docs[s] == 0:
                doc_base[s] = self.num_documents + a
            shard_docs[s] += b - a
        # Empty shards past the new tail keep a doc_base past every live id,
        # so the boundary search of the subset mapping stays monotone.
        new_nd = self.num_documents + nb
        doc_base[(shard_docs == 0) & (doc_base < new_nd)] = new_nd
        out = dataclasses.replace(
            self,
            grids=list(self.grids),
            scales=list(self.scales),
            doclens=list(self.doclens),
            num_documents=new_nd,
            num_embeddings=self.num_embeddings + btok,
            doc_base_host=doc_base,
            shard_docs_host=shard_docs,
        )
        self.append_tail.n_docs = new_nd
        return out


def shard_grid_scores(sg: ShardedGridIndex, i: int, queries: torch.Tensor) -> torch.Tensor:
    """Local shard i's kernel scores [Q, rows] of `queries` [Q, Tq, d] f32
    on its device: the int8 kernel over queries quantized on the device, or
    the bf16 kernel."""
    q_n, tq, d = queries.shape
    qflat = queries.reshape(q_n * tq, d)
    if sg.is_int8:
        qi8, qscale = quantize_queries_int8(qflat)
        return maxsim_grid_scores_int8i(qi8, qscale, sg.grids[i], sg.scales[i], tq=tq)
    return maxsim_grid_scores(qflat.to(torch.bfloat16), sg.grids[i], sg.doclens[i], tq=tq)


def grid_tiles(
    sg: ShardedGridIndex,
    queries: Dict[torch.device, torch.Tensor],
    top_k: int,
    subset: Optional[Sequence[int]] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each local shard's (scores, global ids) top-k tiles for `queries`
    ([Q, Tq, d] f32 on each mesh device): kernel scores, rows past the
    shard's live docs and outside `subset` masked. Launched one shard after
    another with no wait."""
    rows = sg.rows
    if subset is not None:
        ids = np.asarray(list(subset), np.int64)
        ids = ids[(ids >= 0) & (ids < sg.num_documents)]
        # The real boundaries: appends grow the tail past the split.
        ends = sg.doc_base_host + sg.shard_docs_host
        shard_of = np.clip(np.searchsorted(ends, ids, side="right"), 0, sg.n_shards - 1)
        local = ids - sg.doc_base_host[shard_of]
    tiles = []
    for i, s in enumerate(sg.mesh.local_shards):
        dev = sg.grids[i].device
        scores = shard_grid_scores(sg, i, queries[dev])
        valid = torch.arange(rows, device=dev) < int(sg.shard_docs_host[s])
        if subset is not None:
            mask = np.zeros(rows, bool)
            mask[local[shard_of == s]] = True
            valid &= torch.from_numpy(mask).to(dev)
        scores = scores.masked_fill(~valid[None, :], NEG_INF)
        top_s, top_i = _topk_wide(scores, min(top_k, rows))
        tiles.append(_local_tiles(top_s, top_i, int(sg.doc_base_host[s])))
    return tiles


def search_batch_sharded_grid(
    sg: ShardedGridIndex,
    queries: Sequence[np.ndarray],
    params: Optional[SearchParameters] = None,
    subset: Optional[Sequence[int]] = None,
) -> List[QueryResult]:
    """Exact search over the sharded grid: every shard's kernel scores and
    local top-k (`grid_tiles`), then the merge."""
    params = params or SearchParameters()
    if not queries:
        return []
    q_t = torch.from_numpy(_pad_queries(queries, sg.dim)[0])
    tiles = grid_tiles(sg, _on_devices(sg.mesh.devices, q_t.to), params.top_k, subset)
    ids, scores = merge_tiles(sg.mesh, tiles, params.top_k)
    return _results(ids, scores, len(queries))
