"""DeviceIndex: the PLAID index as device-resident tensors.

PyTorch counterpart of `nextplaid_tpu.index.container`. The hot tables live
in device memory with the JAX package's shapes and padding:

  centroids      [K, d]            f32
  codes          [Nvec_pad]        i32   (token -> centroid id)
  residuals      [Nvec_pad, pd]    u8    (packed 2/4-bit residuals)
  doc_offsets    [ndocs_pad + 1]   i32   (CSR over the token table)
  doclens        [ndocs_pad]       i32   (0 beyond num_documents)
  ivf_offsets    [K + 1]           i32   (CSR over posting lists)
  ivf_doc_ids    [nnz_pad]         i32
  token_grid     [ND_grid, Td, d]  bf16 or int8 (optional pinned corpus)
  token_scales   [ND_grid, Td]     bf16  (per-token dequant scales, int8 only)

The int8 grid is doc-major like the bf16 one. The JAX package stores it
token-interleaved in 128-doc groups ([NB, d, 128*Td], a TPU lane layout);
`int8_grid_from_interleaved` / `int8_grid_to_interleaved` convert between
the two bit for bit.

`load_grid_only` builds an index that holds only the grid (single, or one
grid per doclen bucket) and, for the int8 refinement rerank, the codes and
residuals: exact-only serving of corpora whose full index and grid would not
fit together.

The on-disk representation is next-plaid's chunked NPY + JSON directory
(src/index.rs:373-528), so indexes are interchangeable with the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.config import Metadata
from nextplaid_tpu_torch.ops import codec as codec_ops
from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json, load_npy
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device
from nextplaid_tpu_torch.utils.errors import StorageError, UpdateError

# Padding of the doc and token axes, as in the JAX package.
PAD_DOCS = 8
PAD_TOKENS = 128

# Docs decompressed per step while the token grid is built: bounds the f32
# temporary to GRID_BUILD_TILE * Td * d * 4 bytes (80 MB at Td 304, d 128).
GRID_BUILD_TILE = 512

# Geometric probe counts for posting_mass_prefix (see DeviceIndex field).
_MASS_COUNTS = (64, 128, 256, 512, 1024, 2048, 4096)


def _posting_mass_prefix(ivf_lengths: np.ndarray) -> Tuple[int, ...]:
    """Sum of the top-`c` posting lengths for each c in _MASS_COUNTS."""
    if ivf_lengths is None or len(ivf_lengths) == 0:
        return ()
    desc = np.sort(np.asarray(ivf_lengths, np.int64))[::-1]
    csum = np.cumsum(desc)
    total = int(csum[-1])
    return tuple(
        int(csum[min(c, len(desc)) - 1]) if c <= len(desc) else total
        for c in _MASS_COUNTS
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _grid_td_for(max_doclen: int, dtype: str) -> int:
    """Token-axis padding of the pinned grid: a multiple of 8 for bf16 (32 for
    the JAX package's int8 grid), so Td 300 pads to 304."""
    mult = 32 if dtype == "int8" else 8
    return max(_round_up(max(max_doclen, 1), mult), mult)


def _grid_bytes_for(rows: int, max_doclen: int, dim: int, dtype: str) -> int:
    per_tok = dim * 2 if dtype == "bf16" else dim + 2
    return rows * _grid_td_for(max_doclen, dtype) * per_tok


def _padded_doc_rows(ndocs: int, doc_capacity: int = 0) -> int:
    """Doc rows after padding: +1 sentinel slot (doclen 0), or `doc_capacity`
    rows when that is more (headroom for in-place appends), rounded up to
    PAD_DOCS. One rule for `from_host` and `plan_capacity_factor`, so
    headroom planning predicts the pinning outcome."""
    return _round_up(max(ndocs + 1, doc_capacity), PAD_DOCS)


def _grid_rows_for(nd_pad: int, dtype: str = "bf16") -> int:
    """Rows of the pinned grid: the JAX package's layout, 512 slack rows
    past the padded doc rows, rounded up to its build tile (64 docs for
    bf16, one 128-doc group for int8)."""
    return _round_up(nd_pad + 512, 128 if dtype == "int8" else 64)


def _to_tensor(x: np.ndarray, dtype: torch.dtype, device: torch.device):
    # A copy: loaded arrays are read-only memory maps.
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _pad_to(t: torch.Tensor, n: int, edge: bool = False) -> torch.Tensor:
    """`t` with its leading axis zero- (or edge-) padded to length n; `t`
    itself when it is already that long."""
    if t.shape[0] >= n:
        return t
    out = torch.zeros((n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    if edge and t.shape[0]:
        out[t.shape[0]:] = t[-1]
    out[: t.shape[0]] = t
    return out


class _AppendTail:
    """Doc count of the newest index made by `append_batch` in a family of
    DeviceIndex objects that share codes, residuals, doclens and offsets
    (each made from another by `dataclasses.replace`: pinned and unpinned,
    refreshed and stale, grown and not). None before the family's first
    append."""

    __slots__ = ("n_docs",)

    def __init__(self) -> None:
        self.n_docs: Optional[int] = None


@dataclass
class DeviceIndex:
    """PLAID index resident on a device, as a plain dataclass of tensors.

    Live counts are Python ints; array shapes are padded capacities."""

    centroids: torch.Tensor  # [K, d] f32
    codes: torch.Tensor  # [Nvec_pad] i32
    residuals: torch.Tensor  # [Nvec_pad, packed_dim] u8
    doc_offsets: torch.Tensor  # [ndocs_pad + 1] i32
    doclens: torch.Tensor  # [ndocs_pad] i32 (0 beyond num_documents)
    ivf_offsets: torch.Tensor  # [K + 1] i32
    ivf_doc_ids: torch.Tensor  # [nnz_pad] i32
    bucket_cutoffs: torch.Tensor  # [2^nbits - 1] f32
    bucket_weights: torch.Tensor  # [2^nbits] f32
    avg_residual: torch.Tensor  # [d] f32
    # Optional pinned decompressed corpus [ND_grid, Td, d], bf16 or int8,
    # token rows at or beyond a doc's length zeroed.
    token_grid: Optional[torch.Tensor] = None
    # Per-token dequant scales [ND_grid, Td] bf16, present iff token_grid is
    # int8 (token ~= int8 row * scale; 0 marks an invalid token).
    token_scales: Optional[torch.Tensor] = None
    n_docs: int = 0
    n_emb: int = 0
    nbits: int = 4
    max_doclen: int = 0
    # Longest posting list: caps the staged pipeline's posting budget.
    max_posting_len: int = 0
    # posting_mass_prefix[i] = sum of the _MASS_COUNTS[i] longest posting
    # lists: a skew-proof upper bound on the posting mass any probe of that
    # many cells can select, so a posting budget at the bound never
    # overflows. Empty on grid-only indexes (no IVF).
    posting_mass_prefix: Tuple[int, ...] = ()
    # Grid-only serving (`load_grid_only`): the IVF is a 0-row placeholder
    # and only exact search over the grid is valid. codes/residuals are
    # 0-row too unless refine="device" kept them resident for the int8
    # refinement rerank.
    grid_only: bool = False
    # Bucketed-Td grids (`load_grid_only(buckets=...)`): docs partitioned
    # into doclen buckets, each a grid [rows_b, Td_b, d] with its own Td
    # (and scales [rows_b, Td_b] when int8). Rows are bucket-major:
    # `grid_perm` maps a concatenated grid row to its doc id (-1 for
    # alignment padding) and `grid_doclens` holds each row's length. With
    # buckets, token_grid/token_scales are None.
    grid_buckets: Tuple[torch.Tensor, ...] = ()
    scale_buckets: Tuple[torch.Tensor, ...] = ()
    grid_perm: Optional[torch.Tensor] = None  # [total_rows] i32
    grid_doclens: Optional[torch.Tensor] = None  # [total_rows] i32
    # Host-resident compressed corpus for the refinement rerank
    # (`load_grid_only(refine="host")`).
    refine_host: Optional["HostRefineData"] = None
    # True after `append_batch` until `refresh_ivf`: the IVF lacks the
    # appended docs, so the staged route reroutes to exhaustive search.
    ivf_stale: bool = False
    # Shared by every object `dataclasses.replace` makes from this one, so
    # that only an index at the family's newest count may append: an older
    # one would write over rows that a successor already serves.
    append_tail: _AppendTail = field(
        default_factory=_AppendTail, repr=False, compare=False
    )

    @property
    def num_documents(self) -> int:
        return self.n_docs

    @property
    def num_embeddings(self) -> int:
        return self.n_emb

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[0]

    def posting_mass_bound(self, ncells: int) -> Optional[int]:
        """Upper bound on the posting mass of any `ncells`-cell probe: the
        sum of the `ncells` longest posting lists (rounded up to the next
        geometric prefix count). None when the stat is absent or `ncells`
        exceeds the recorded counts."""
        if not self.posting_mass_prefix:
            return None
        for c, mass in zip(_MASS_COUNTS, self.posting_mass_prefix):
            if ncells <= c:
                return mass
        return None

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def num_docs_padded(self) -> int:
        return self.doclens.shape[0]

    # ------------------------------------------------------------------
    # Pinned decompressed corpus
    # ------------------------------------------------------------------
    def grid_td(self, dtype: str = "bf16") -> int:
        return _grid_td_for(self.max_doclen, dtype)

    def grid_token_axis(self) -> int:
        """Td of the pinned grid (axis 1 for both dtypes in this package)."""
        assert self.token_grid is not None
        return self.token_grid.shape[1]

    def grid_doc_rows(self) -> int:
        """Doc rows of the pinned grid."""
        assert self.token_grid is not None
        return self.token_grid.shape[0]

    def token_axis(self) -> int:
        """Td that exact scoring walks: the pinned grid's token axis, else
        max_doclen padded as a bf16 grid's would be."""
        if self.token_grid is not None:
            return self.token_grid.shape[1]
        return self.grid_td("bf16")

    @property
    def has_grid(self) -> bool:
        """True when a pinned token grid (single or bucketed) is present."""
        return self.token_grid is not None or bool(self.grid_buckets)

    @property
    def grid_is_int8(self) -> bool:
        return self.token_scales is not None or bool(self.scale_buckets)

    @property
    def refine_side(self) -> str:
        """Resolved grid-only refinement side: "device" (codes/residuals
        resident), "host" (gathered from the chunk files per batch) or
        "none"."""
        if not self.grid_only:
            return "none"
        if self.codes.shape[0] > 0:
            return "device"
        if self.refine_host is not None:
            return "host"
        return "none"

    def grid_bytes(self, dtype: str = "bf16") -> int:
        return _grid_bytes_for(
            self.num_docs_padded, self.max_doclen, self.dim, dtype
        )

    def with_token_grid(
        self, budget_mb: Optional[int] = None, dtype: Optional[str] = None
    ) -> "DeviceIndex":
        """Return a copy carrying the decompressed [ND_grid, Td, d] token
        grid, or self unchanged if it exceeds the budget
        (NEXT_PLAID_PIN_BUDGET_MB, default 4096).

        dtype (or NEXT_PLAID_PIN_DTYPE): "bf16", "int8", or "auto" (the
        default), which pins bf16 when it fits and falls back to int8: per-
        token symmetric quantization with a bf16 scale per token, d + 2
        bytes a token instead of 2d."""
        if self.has_grid or self.num_documents == 0:
            return self
        if budget_mb is None:
            budget_mb = int(os.environ.get("NEXT_PLAID_PIN_BUDGET_MB", "4096"))
        if dtype is None:
            dtype = os.environ.get("NEXT_PLAID_PIN_DTYPE", "auto")
        if dtype not in ("bf16", "int8", "auto"):
            logging.getLogger(__name__).warning(
                "NEXT_PLAID_PIN_DTYPE=%r is not one of bf16|int8|auto; "
                "treating as auto",
                dtype,
            )
            dtype = "auto"
        budget = budget_mb << 20
        if dtype == "auto":
            if self.grid_bytes("bf16") <= budget:
                dtype = "bf16"
            elif self.grid_bytes("int8") <= budget:
                # Loud, because this changes scoring precision for every
                # query on this index.
                logging.getLogger(__name__).warning(
                    "token grid auto-pinning falling back to int8: bf16 "
                    "grid needs %d MB > budget %d MB. Exact-search scores "
                    "are now int8-quantized. Set NEXT_PLAID_PIN_DTYPE=bf16 "
                    "to keep full precision (unpinned if over budget), or "
                    "int8 to silence this warning.",
                    self.grid_bytes("bf16") >> 20,
                    budget_mb,
                )
                dtype = "int8"
            else:
                return self
        elif self.grid_bytes(dtype) > budget:
            return self
        if dtype == "bf16":
            grid = _build_token_grid(self, self.grid_td("bf16"))
            return dataclasses.replace(self, token_grid=grid)
        grid, scales = _build_token_grid_int8(self, self.grid_td("int8"))
        return dataclasses.replace(self, token_grid=grid, token_scales=scales)

    # ------------------------------------------------------------------
    # Incremental append (serving ingest)
    # ------------------------------------------------------------------
    def append_batch(
        self,
        codes: np.ndarray,
        residuals: np.ndarray,
        doclens: np.ndarray,
    ) -> Optional["DeviceIndex"]:
        """Append encoded documents on the device: O(batch) host-to-device
        traffic instead of a full reload and re-pin.

        `codes` / `residuals` / `doclens` are a batch encoded against the
        index's current centroids (`update`'s `info_out["encoded"]` in buffer
        mode). The capacity rule is the JAX package's: when `num_documents +
        round_up(batch docs, 256) + 1` exceeds the doc rows or `num_embeddings
        + round_up(batch tokens, 2048)` the token rows, `_grow` doubles the
        capacity first, so padded shapes (and with them grid rows and kernel
        launch plans) equal the JAX package's after any append sequence.

        Design: writes are in place. The JAX package's append is functional;
        here the batch's codes, residuals, doclens and doc offsets, and its
        grid rows (decompressed by `decompress_windows`; bf16-rounded, or
        quantized by `quantize_tokens_int8` into the doc-major int8 grid and
        its scales) are slice-assigned at the live counts, into tensors that
        this index and the returned one share. This index still answers for
        its own documents: every score path masks by the object's own
        `num_documents`, and a search enqueued on it before the append is
        ahead of the writes in stream order. Only an index at the newest
        count of the objects that share these tensors (`append_tail`) may
        append: an older one, or a sibling made beside it by
        `with_token_grid` or `refresh_ivf`, would write over rows that the
        successor serves, so it raises UpdateError. The JAX
        package's `_write_int8_groups` (its token-interleaved 128-doc groups)
        has no counterpart: this package's int8 grid is doc-major, so a row
        is written where it lies.

        The IVF is not updated: the result is marked `ivf_stale` until
        `refresh_ivf`. Returns None when a new document is longer than the
        pinned grid's token axis (the caller reloads); raises UpdateError on
        a grid-only index."""
        if self.grid_only:
            raise UpdateError(
                "grid-only index is immutable; reload with DeviceIndex.load "
                "to append"
            )
        nd, ne = self.num_documents, self.num_embeddings
        tail = self.append_tail
        if tail.n_docs is not None and tail.n_docs != nd:
            raise UpdateError(
                f"this index ({nd} docs) shares its tensors with a successor "
                f"of {tail.n_docs} docs made by append_batch; append to the "
                "newest index"
            )
        doclens = np.asarray(doclens, np.int64)
        bdocs = int(doclens.shape[0])
        btok = int(doclens.sum())
        if bdocs == 0:
            return self
        codes, residuals = np.asarray(codes), np.asarray(residuals)
        if codes.shape[0] != btok or residuals.shape[0] != btok:
            raise ValueError(
                f"batch shapes disagree: {codes.shape[0]} codes / "
                f"{residuals.shape[0]} residuals vs doclens sum {btok}"
            )
        if self.token_grid is not None and int(doclens.max()) > self.grid_token_axis():
            return None  # longer than the grid's token axis: reload

        index = self
        bdocs_pad = _round_up(bdocs, 256)
        btok_pad = _round_up(btok, 2048)
        if (
            nd + bdocs_pad + 1 > index.num_docs_padded
            or ne + btok_pad > index.codes.shape[0]
        ):
            index = index._grow(
                doc_capacity=max(2 * index.num_docs_padded, nd + bdocs_pad + 2),
                token_capacity=max(2 * index.codes.shape[0], ne + btok_pad),
            )
        dev = index.device
        new_codes = torch.from_numpy(codes.astype(np.int32)).to(dev)
        new_res = torch.from_numpy(np.ascontiguousarray(residuals, np.uint8)).to(dev)
        lens = torch.from_numpy(doclens.astype(np.int32)).to(dev)
        index.codes[ne : ne + btok] = new_codes
        index.residuals[ne : ne + btok] = new_res
        index.doclens[nd : nd + bdocs] = lens
        # Offsets over the batch's padded doc window, as the JAX package
        # writes them: past the real docs they repeat the new total.
        lens_pad = torch.zeros(bdocs_pad, dtype=torch.int32, device=dev)
        lens_pad[:bdocs] = lens
        index.doc_offsets[nd + 1 : nd + 1 + bdocs_pad] = index.doc_offsets[nd] + torch.cumsum(
            lens_pad, 0, dtype=torch.int32
        )

        if index.token_grid is not None:
            td = index.token_grid.shape[1]
            starts = torch.zeros(bdocs, dtype=torch.int64, device=dev)
            starts[1:] = torch.cumsum(lens[:-1], 0)
            t_ar = torch.arange(td, device=dev)
            for s in range(0, bdocs, GRID_BUILD_TILE):
                sl = slice(s, s + GRID_BUILD_TILE)
                emb = decompress_windows(
                    new_codes, new_res, starts[sl], lens[sl], td,
                    index.centroids, index.bucket_weights, index.nbits,
                )
                rows = slice(nd + s, nd + s + emb.shape[0])
                if index.token_scales is None:
                    index.token_grid[rows] = emb.to(torch.bfloat16)
                else:
                    q, sc = quantize_tokens_int8(emb, t_ar[None, :] < lens[sl, None])
                    index.token_grid[rows] = q
                    index.token_scales[rows] = sc
        out = dataclasses.replace(
            index,
            n_docs=nd + bdocs,
            n_emb=ne + btok,
            max_doclen=max(index.max_doclen, int(doclens.max())),
            ivf_stale=True,
        )
        tail.n_docs = out.num_documents
        return out

    def _grow(self, doc_capacity: int, token_capacity: int) -> "DeviceIndex":
        """Re-pad the capacity arrays and rebuild the pinned grid at the new
        rows (rare). The new grid is built while the old one is alive, so
        for a moment both are held; when the grown bf16 grid no longer fits
        the pin budget, the auto policy downgrades it to int8, then to
        unpinned, with a warning."""
        nd_pad_new = max(_round_up(doc_capacity, PAD_DOCS), self.num_docs_padded)
        nvec_new = max(_round_up(token_capacity, PAD_TOKENS), self.codes.shape[0])
        grown = dataclasses.replace(
            self,
            codes=_pad_to(self.codes, nvec_new),
            residuals=_pad_to(self.residuals, nvec_new),
            doclens=_pad_to(self.doclens, nd_pad_new),
            doc_offsets=_pad_to(self.doc_offsets, nd_pad_new + 1, edge=True),
            token_grid=None,
            token_scales=None,
        )
        if self.token_grid is not None:
            dtype = "int8" if self.token_scales is not None else "bf16"
            pinned = grown.with_token_grid(dtype=dtype)
            if pinned.token_grid is None and dtype == "bf16":
                # The doubled bf16 grid is over the pin budget: the auto
                # path's downgrade (bf16 -> int8, with its warning ->
                # unpinned).
                pinned = grown.with_token_grid(dtype="auto")
            grown = pinned
            if grown.token_grid is None:
                budget_mb = int(os.environ.get("NEXT_PLAID_PIN_BUDGET_MB", "4096"))
                logging.getLogger(__name__).warning(
                    "capacity growth dropped the pinned token grid: %s "
                    "grid needs %d MB > NEXT_PLAID_PIN_BUDGET_MB=%d; "
                    "serving falls back to the unpinned scan (large "
                    "latency regression). Raise the budget or shard "
                    "across chips.",
                    dtype,
                    grown.grid_bytes(dtype) >> 20,
                    budget_mb,
                )
        return grown

    def refresh_ivf(self, index_path: str) -> "DeviceIndex":
        """The index with its IVF (and posting statistics) re-read from disk:
        the staged pipeline's catch-up after appends. The result is no longer
        stale."""
        if self.grid_only:
            raise UpdateError(
                "grid-only index has no IVF; reload with DeviceIndex.load"
            )
        layout = IndexLayout(index_path)
        ivf = np.asarray(load_npy(layout.ivf), np.int32)
        ivf_lengths = np.asarray(load_npy(layout.ivf_lengths), np.int64)
        k = self.num_centroids
        ivf_offsets = np.zeros(k + 1, np.int32)
        np.cumsum(ivf_lengths[:k], out=ivf_offsets[1:])
        nnz = int(ivf.shape[0])
        nnz_pad = max(_round_up(nnz, PAD_TOKENS), PAD_TOKENS)
        ivf_p = np.full(nnz_pad, self.num_docs_padded - 1, np.int32)
        ivf_p[:nnz] = ivf
        return dataclasses.replace(
            self,
            ivf_offsets=_to_tensor(ivf_offsets, torch.int32, self.device),
            ivf_doc_ids=_to_tensor(ivf_p, torch.int32, self.device),
            max_posting_len=int(ivf_lengths.max()) if nnz else 0,
            posting_mass_prefix=_posting_mass_prefix(ivf_lengths[:k]),
            ivf_stale=False,
        )

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_host(
        cls,
        centroids: np.ndarray,
        codes: np.ndarray,
        residuals: np.ndarray,
        doclens: np.ndarray,
        ivf_lengths: np.ndarray,
        ivf_doc_ids: np.ndarray,
        bucket_cutoffs: np.ndarray,
        bucket_weights: np.ndarray,
        avg_residual: np.ndarray,
        nbits: int,
        doc_capacity: int = 0,
        token_capacity: int = 0,
        device: DeviceLike = None,
    ) -> "DeviceIndex":
        """Pad host arrays as the JAX package does and stage them on
        `device` ("cuda" when None). `doc_capacity` / `token_capacity`
        reserve rows past the live counts that `append_batch` fills in
        place. At 0 (the default) the shapes are the live counts padded."""
        device = resolve_device(device)
        ndocs = int(doclens.shape[0])
        nvec = int(codes.shape[0])
        k, d = centroids.shape
        packed_dim = d * nbits // 8
        if residuals.shape != (nvec, packed_dim):
            raise ValueError(
                f"residuals {residuals.shape} != {(nvec, packed_dim)}"
            )

        # +1 so the sentinel slot (doclen 0) is always in bounds.
        ndocs_pad = _padded_doc_rows(ndocs, doc_capacity)
        nvec_pad = max(_round_up(max(nvec, token_capacity), PAD_TOKENS), PAD_TOKENS)
        nnz = int(ivf_doc_ids.shape[0])
        nnz_pad = max(_round_up(nnz, PAD_TOKENS), PAD_TOKENS)

        doclens_p = np.zeros(ndocs_pad, np.int32)
        doclens_p[:ndocs] = doclens
        doc_offsets = np.zeros(ndocs_pad + 1, np.int32)
        np.cumsum(doclens_p, out=doc_offsets[1:])

        codes_p = np.zeros(nvec_pad, np.int32)
        codes_p[:nvec] = codes
        residuals_p = np.zeros((nvec_pad, packed_dim), np.uint8)
        residuals_p[:nvec] = residuals

        ivf_offsets = np.zeros(k + 1, np.int32)
        np.cumsum(np.asarray(ivf_lengths, np.int64), out=ivf_offsets[1:])
        # Sentinel = last padded slot, whose doclen is 0.
        ivf_p = np.full(nnz_pad, ndocs_pad - 1, np.int32)
        ivf_p[:nnz] = ivf_doc_ids

        return cls(
            centroids=_to_tensor(centroids, torch.float32, device),
            codes=_to_tensor(codes_p, torch.int32, device),
            residuals=_to_tensor(residuals_p, torch.uint8, device),
            doc_offsets=_to_tensor(doc_offsets, torch.int32, device),
            doclens=_to_tensor(doclens_p, torch.int32, device),
            ivf_offsets=_to_tensor(ivf_offsets, torch.int32, device),
            ivf_doc_ids=_to_tensor(ivf_p, torch.int32, device),
            bucket_cutoffs=_to_tensor(bucket_cutoffs, torch.float32, device),
            bucket_weights=_to_tensor(bucket_weights, torch.float32, device),
            avg_residual=_to_tensor(avg_residual, torch.float32, device),
            n_docs=ndocs,
            n_emb=nvec,
            nbits=nbits,
            max_doclen=int(np.max(doclens)) if ndocs else 0,
            max_posting_len=int(np.max(ivf_lengths)) if nnz else 0,
            posting_mass_prefix=_posting_mass_prefix(ivf_lengths),
        )

    @classmethod
    def from_reference_arrays(
        cls,
        arrays: Dict[str, np.ndarray],
        nbits: int,
        max_doclen: int,
        num_documents: int,
        num_embeddings: int,
        device: DeviceLike = None,
        grid_only: bool = False,
    ) -> "DeviceIndex":
        """Build the index from the padded arrays of a `nextplaid_tpu`
        DeviceIndex, converted to numpy, so both packages score the same
        state. `arrays` holds the tensor fields by name (centroids, codes,
        residuals, doc_offsets, doclens, ivf_offsets, ivf_doc_ids,
        bucket_cutoffs, bucket_weights, avg_residual) and optionally:
          - `token_grid`: a bf16 grid [ND, Td, d] (as bfloat16 or as float32
            holding bf16 values), or the JAX package's token-interleaved
            int8 grid [NB, d, 128*Td] with its `token_scales` [NB, 128*Td];
          - the bucketed layout: `grid_buckets` and `scale_buckets` (lists,
            each bucket as above), `grid_perm` and `grid_doclens`.
        Bf16 values may come as float32; int8 grids are converted to this
        package's doc-major layout."""
        device = resolve_device(device)
        dtypes = {
            "centroids": torch.float32,
            "codes": torch.int32,
            "residuals": torch.uint8,
            "doc_offsets": torch.int32,
            "doclens": torch.int32,
            "ivf_offsets": torch.int32,
            "ivf_doc_ids": torch.int32,
            "bucket_cutoffs": torch.float32,
            "bucket_weights": torch.float32,
            "avg_residual": torch.float32,
        }
        fields = {
            name: _to_tensor(np.asarray(arrays[name]), dt, device)
            for name, dt in dtypes.items()
        }

        def grid_of(grid, scales):
            grid = np.asarray(grid)
            if scales is None:
                # numpy has no bfloat16 of its own (JAX hands out ml_dtypes').
                return _to_tensor(grid.astype(np.float32), torch.bfloat16, device), None
            return int8_grid_from_interleaved(
                _to_tensor(grid, torch.int8, device),
                _to_tensor(np.asarray(scales).astype(np.float32), torch.bfloat16, device),
            )

        grid = scales = None
        if arrays.get("token_grid") is not None:
            grid, scales = grid_of(arrays["token_grid"], arrays.get("token_scales"))
        buckets, scale_buckets = [], []
        scale_list = list(arrays.get("scale_buckets") or ())
        for b, g in enumerate(arrays.get("grid_buckets") or ()):
            gb, sb = grid_of(g, scale_list[b] if scale_list else None)
            buckets.append(gb)
            if sb is not None:
                scale_buckets.append(sb)
        perm = arrays.get("grid_perm")
        bucket_lens = arrays.get("grid_doclens")
        # Posting statistics as the JAX package derives them at load, here
        # from the carried CSR offsets (a grid-only index has no IVF).
        ivf_lengths = np.diff(np.asarray(arrays["ivf_offsets"], np.int64))
        has_ivf = not grid_only and int(ivf_lengths.sum()) > 0
        return cls(
            **fields,
            token_grid=grid,
            token_scales=scales,
            n_docs=int(num_documents),
            n_emb=int(num_embeddings),
            nbits=int(nbits),
            max_doclen=int(max_doclen),
            max_posting_len=int(ivf_lengths.max()) if has_ivf else 0,
            posting_mass_prefix=_posting_mass_prefix(ivf_lengths) if has_ivf else (),
            grid_only=bool(grid_only),
            grid_buckets=tuple(buckets),
            scale_buckets=tuple(scale_buckets),
            grid_perm=None if perm is None else _to_tensor(perm, torch.int32, device),
            grid_doclens=None
            if bucket_lens is None
            else _to_tensor(np.asarray(bucket_lens).reshape(-1), torch.int32, device),
        )

    @staticmethod
    def plan_capacity_factor(
        n_docs: int,
        max_doclen: int,
        dim: int,
        requested: float,
        budget_mb: Optional[int] = None,
        dtype: Optional[str] = None,
    ) -> float:
        """Shrink append headroom when it would degrade the pinning outcome.

        The pinned grid is capacity-sized (appends write into its reserved
        rows in place), so headroom rows count in `grid_bytes` and can flip
        `with_token_grid`'s budget decision from bf16 to int8 or to unpinned
        for rows that hold no documents. Returns `requested` when the dtype
        outcome matches a headroom-free load; otherwise warns and returns
        1.0 (the first append then pays one capacity growth instead of every
        query paying degraded scoring)."""
        if requested <= 1.0 or n_docs == 0:
            return max(requested, 1.0)
        if budget_mb is None:
            budget_mb = int(os.environ.get("NEXT_PLAID_PIN_BUDGET_MB", "4096"))
        if dtype is None:
            dtype = os.environ.get("NEXT_PLAID_PIN_DTYPE", "auto")
        if dtype not in ("bf16", "int8"):
            dtype = "auto"
        budget = budget_mb << 20

        def outcome(rows: int) -> str:
            def fits(dt: str) -> bool:
                return _grid_bytes_for(rows, max_doclen, dim, dt) <= budget

            if dtype == "auto":
                if fits("bf16"):
                    return "bf16"
                return "int8" if fits("int8") else "none"
            return dtype if fits(dtype) else "none"

        def rows(factor: float) -> int:
            cap = int(n_docs * factor) + 2 if factor > 1.0 else 0
            return _padded_doc_rows(n_docs, cap)

        plain, with_headroom = outcome(rows(1.0)), outcome(rows(requested))
        if with_headroom == plain:
            return requested
        logging.getLogger(__name__).warning(
            "append headroom (capacity_factor=%.2f) would change the "
            "token-grid pinning outcome from %s to %s; loading without "
            "headroom to preserve scoring precision (the first append "
            "will pay a one-time capacity growth instead)",
            requested,
            plain,
            with_headroom,
        )
        return 1.0

    @classmethod
    def load(
        cls,
        index_path: str,
        capacity_factor: float = 1.0,
        grid_aware_capacity: bool = False,
        device: DeviceLike = None,
    ) -> "DeviceIndex":
        """Load an index directory (next-plaid `MmapIndex::load`,
        src/index.rs:1026) onto `device` ("cuda" when None).

        `capacity_factor` > 1 reserves append headroom: a serving process
        that expects ingest loads with e.g. 1.5 so the first batches do not
        trigger a capacity growth (a re-pad and a grid rebuild).
        `grid_aware_capacity` drops the headroom when it would change the
        grid's pinning outcome (`plan_capacity_factor`)."""
        device = resolve_device(device)
        h = load_host_arrays(index_path)
        doclens, codes = h["doclens"], h["codes"]
        f = max(capacity_factor, 1.0)
        if f > 1.0 and grid_aware_capacity:
            f = cls.plan_capacity_factor(
                n_docs=int(doclens.shape[0]),
                max_doclen=int(doclens.max()) if doclens.size else 0,
                dim=int(h["centroids"].shape[1]),
                requested=f,
            )
        return cls.from_host(
            centroids=h["centroids"],
            codes=codes,
            residuals=h["residuals"],
            doclens=doclens,
            ivf_lengths=h["ivf_lengths"],
            ivf_doc_ids=h["ivf"],
            bucket_cutoffs=h["bucket_cutoffs"],
            bucket_weights=h["bucket_weights"],
            avg_residual=h["avg_residual"],
            nbits=h["meta"].nbits,
            doc_capacity=int(len(doclens) * f) + 2 if f > 1.0 else 0,
            token_capacity=int(len(codes) * f) if f > 1.0 else 0,
            device=device,
        )


def load_host_arrays(index_path: str) -> dict:
    """Host side of an index load: metadata and the chunk arrays,
    concatenated with numpy. (The JAX package's merge cache and native
    loader are not ported.)"""
    layout = IndexLayout(index_path)
    meta = Metadata.from_dict(load_json(layout.metadata))

    centroids = np.asarray(load_npy(layout.centroids), np.float32)
    packed_dim = centroids.shape[1] * meta.nbits // 8
    chunks = range(meta.num_chunks)
    codes_list: List[np.ndarray] = [
        np.asarray(load_npy(layout.chunk_codes(i))) for i in chunks
    ]
    res_list: List[np.ndarray] = [
        np.asarray(load_npy(layout.chunk_residuals(i))) for i in chunks
    ]
    doclens_list: List[np.ndarray] = [
        np.asarray(load_json(layout.chunk_doclens(i)), np.int64) for i in chunks
    ]
    codes = np.concatenate(codes_list) if codes_list else np.zeros(0, np.int64)
    residuals = (
        np.concatenate(res_list)
        if res_list
        else np.zeros((0, packed_dim), np.uint8)
    )
    doclens = (
        np.concatenate(doclens_list) if doclens_list else np.zeros(0, np.int64)
    )
    return {
        "meta": meta,
        "centroids": centroids,
        "bucket_cutoffs": np.asarray(load_npy(layout.bucket_cutoffs), np.float32),
        "bucket_weights": np.asarray(load_npy(layout.bucket_weights), np.float32),
        "avg_residual": np.asarray(load_npy(layout.avg_residual), np.float32),
        "codes": codes.astype(np.int32),
        "residuals": residuals,
        "doclens": doclens.astype(np.int32),
        "ivf": np.asarray(load_npy(layout.ivf), np.int32),
        "ivf_lengths": np.asarray(load_npy(layout.ivf_lengths), np.int64),
    }


def decompress_windows(
    codes: torch.Tensor,
    residuals: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    td: int,
    centroids: torch.Tensor,
    bucket_weights: torch.Tensor,
    nbits: int,
) -> torch.Tensor:
    """Decompressed, renormalized token windows [n, td, d] f32: window i is
    tokens starts[i] + [0, td) of `codes`/`residuals`, rows at or beyond
    lens[i] zeroed."""
    t_ar = torch.arange(td, device=codes.device)
    tok_pos = torch.clamp(
        starts.long()[:, None] + t_ar[None, :], 0, max(codes.shape[0] - 1, 0)
    )
    emb = codec_ops.decompress_residuals(
        residuals[tok_pos], codes[tok_pos], centroids, bucket_weights, nbits,
        normalize=True,
    )
    valid = t_ar[None, :] < lens[:, None]
    return torch.where(valid[:, :, None], emb, torch.zeros((), device=emb.device))


def decompress_docs(
    index: DeviceIndex, doc_ids: torch.Tensor, td: int
) -> torch.Tensor:
    """Decompressed, renormalized tokens of `doc_ids` as [n, td, d] f32, with
    token rows at or beyond each doc's length zeroed. Ids past the padded
    doc rows read as empty docs."""
    nd_pad = index.num_docs_padded
    safe = torch.clamp(doc_ids, max=nd_pad - 1).long()
    lens = torch.where(doc_ids < nd_pad, index.doclens[safe], 0)
    return decompress_windows(
        index.codes, index.residuals, index.doc_offsets[safe], lens, td,
        index.centroids, index.bucket_weights, index.nbits,
    )


def quantize_tokens_int8(
    emb: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 quantization, in the JAX package's order:
    scale = maxabs / 127 in f32 (1.0 for an all-zero token), q =
    clip(round(x / scale), -127, 127) (round half to even), and the scale is
    stored rounded to bf16, 0 for invalid tokens. Returns (q int8 [..., d],
    scales bf16 [...])."""
    maxabs = emb.abs().amax(dim=-1)
    scale = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
    q = torch.clamp(torch.round(emb / scale[..., None]), -127, 127).to(torch.int8)
    stored = torch.where(valid, scale, torch.zeros_like(scale)).to(torch.bfloat16)
    return q, stored


def int8_grid_from_interleaved(
    grid_i: torch.Tensor, scales_i: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's token-interleaved int8 grid ([NB, d, 128*Td], doc
    g*128 + j token t at [g, :, t*128 + j]; scales [NB, 128*Td]) as this
    package's doc-major grid [NB*128, Td, d] and scales [NB*128, Td]. Bit
    exact; `int8_grid_to_interleaved` is the inverse."""
    nb, d, ld = grid_i.shape
    td = ld // 128
    grid = grid_i.reshape(nb, d, td, 128).permute(0, 3, 2, 1).reshape(nb * 128, td, d)
    scales = scales_i.reshape(nb, td, 128).permute(0, 2, 1).reshape(nb * 128, td)
    return grid.contiguous(), scales.contiguous()


def int8_grid_to_interleaved(
    grid: torch.Tensor, scales: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `int8_grid_from_interleaved` (rows a multiple of 128)."""
    rows, td, d = grid.shape
    nb = rows // 128
    grid_i = grid.reshape(nb, 128, td, d).permute(0, 3, 2, 1).reshape(nb, d, 128 * td)
    scales_i = scales.reshape(nb, 128, td).permute(0, 2, 1).reshape(nb, 128 * td)
    return grid_i.contiguous(), scales_i.contiguous()


def _build_token_grid(index: DeviceIndex, td: int) -> torch.Tensor:
    """Decompress the whole corpus once into the padded bf16 token grid
    [ND_grid, td, d] (the JAX package's `_build_token_grid`, same rows)."""
    nd_grid = _grid_rows_for(index.num_docs_padded, "bf16")
    grid = torch.empty(
        (nd_grid, td, index.dim), dtype=torch.bfloat16, device=index.device
    )
    for start in range(0, nd_grid, GRID_BUILD_TILE):
        ids = torch.arange(
            start, min(start + GRID_BUILD_TILE, nd_grid), device=index.device
        )
        grid[start : start + ids.shape[0]] = decompress_docs(index, ids, td).to(
            torch.bfloat16
        )
    return grid


def _build_token_grid_int8(
    index: DeviceIndex, td: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompress and quantize the whole corpus once into the doc-major int8
    grid [ND_grid, td, d] and its bf16 scales [ND_grid, td] (the rows of
    the JAX package's `_build_token_grid_int8`, not its interleave)."""
    nd_grid = _grid_rows_for(index.num_docs_padded, "int8")
    dev = index.device
    grid = torch.empty((nd_grid, td, index.dim), dtype=torch.int8, device=dev)
    scales = torch.empty((nd_grid, td), dtype=torch.bfloat16, device=dev)
    t_ar = torch.arange(td, device=dev)
    nd_pad = index.num_docs_padded
    for start in range(0, nd_grid, GRID_BUILD_TILE):
        ids = torch.arange(start, min(start + GRID_BUILD_TILE, nd_grid), device=dev)
        lens = torch.where(
            ids < nd_pad, index.doclens[torch.clamp(ids, max=nd_pad - 1)], 0
        )
        q, sc = quantize_tokens_int8(
            decompress_docs(index, ids, td), t_ar[None, :] < lens[:, None]
        )
        grid[start : start + ids.shape[0]] = q
        scales[start : start + ids.shape[0]] = sc
    return grid, scales


# ----------------------------------------------------------------------
# Grid-only loading: serve exact search from the pinned grid alone.
# ----------------------------------------------------------------------


def choose_bucket_tds(
    doclens: np.ndarray,
    mult: int,
    max_buckets: int = 4,
    min_gain: float = 0.08,
    row_pad: int = 128,
) -> List[int]:
    """Pick ascending Td boundaries minimizing total grid token slots (a
    copy of the JAX package's `choose_bucket_tds`).

    Candidates are the distinct per-doc round_up(len, mult) values
    (subsampled to <=24 plus the max). Exact DP over (candidate, bucket
    count); each bucket charges `row_pad` extra rows of its Td for the
    per-bucket row alignment, which prices tiny buckets out. Falls back to
    a single global Td when the best bucketing saves < min_gain of slots.
    """
    nd = int(doclens.shape[0])
    if nd == 0:
        return [mult]
    per_doc = np.maximum(
        ((np.maximum(doclens.astype(np.int64), 1) + mult - 1) // mult) * mult,
        mult,
    )
    cands, counts = np.unique(per_doc, return_counts=True)
    if len(cands) > 24:
        keep = np.unique(
            np.concatenate(
                [
                    cands[
                        np.searchsorted(
                            np.cumsum(counts),
                            np.linspace(0, nd - 1, 23).astype(np.int64),
                            side="right",
                        ).clip(0, len(cands) - 1)
                    ],
                    cands[-1:],
                ]
            )
        )
        # Re-bin counts onto the kept boundaries (docs go to the first
        # boundary >= their Td).
        idx = np.searchsorted(keep, cands, side="left")
        counts = np.bincount(idx, weights=counts, minlength=len(keep))
        cands = keep
    single_cost = nd * int(cands[-1])
    n_c = len(cands)
    max_b = min(max_buckets, n_c)
    # f[b][j] = min slots covering candidate prefix 0..j with b buckets,
    # the last bucket's Td = cands[j].
    csum = np.concatenate([[0], np.cumsum(counts)])
    inf = float("inf")
    f = [[inf] * n_c for _ in range(max_b + 1)]
    parent = [[-1] * n_c for _ in range(max_b + 1)]
    for j in range(n_c):
        f[1][j] = csum[j + 1] * int(cands[j]) + row_pad * int(cands[j])
    for b in range(2, max_b + 1):
        for j in range(b - 1, n_c):
            for i in range(b - 2, j):
                c = (
                    f[b - 1][i]
                    + (csum[j + 1] - csum[i + 1]) * int(cands[j])
                    + row_pad * int(cands[j])
                )
                if c < f[b][j]:
                    f[b][j] = c
                    parent[b][j] = i
    best_b = min(range(1, max_b + 1), key=lambda b: f[b][n_c - 1])
    if f[best_b][n_c - 1] >= single_cost * (1.0 - min_gain):
        return [int(cands[-1])]
    tds = []
    b, j = best_b, n_c - 1
    while j >= 0 and b >= 1:
        tds.append(int(cands[j]))
        j = parent[b][j]
        b -= 1
    return sorted(tds)


def _device_hbm_bytes(device: torch.device) -> Optional[int]:
    """Memory of `device` in bytes, or None where there is no such limit to
    check against (the CPU)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def _require_grid_fits(
    grid_bytes: int, staging_bytes: int, device: torch.device
) -> None:
    """Raise StorageError before allocating a grid that cannot fit the
    device: grid(s) (+ resident refine tables) + the peak transient of one
    chunk's build."""
    limit = _device_hbm_bytes(device)
    if limit is None:
        return
    need = grid_bytes + staging_bytes
    if need > limit:
        raise StorageError(
            f"grid-only load needs ~{need >> 20} MB "
            f"(grid {grid_bytes >> 20} MB + chunk staging "
            f"{staging_bytes >> 20} MB) but the device has "
            f"{limit >> 20} MB. Options: dtype='int8' (half the bf16 grid), "
            "buckets>1 (cuts Td padding), refine='host' (no resident refine "
            "tables), or serve unpinned via DeviceIndex.load."
        )


class HostRefineData:
    """Host-resident compressed corpus for the grid-only refinement rerank
    (a copy of the JAX package's). The chunk arrays stay numpy memory maps
    of the chunk files, so untouched pages never load; `gather` pulls the
    token rows of a candidate set for the exact re-score."""

    def __init__(self, chunk_codes, chunk_residuals, chunk_doc_starts,
                 chunk_tok_starts, doc_offsets, doclens):
        self.chunk_codes = chunk_codes  # list of [ctok_i] mmaps
        self.chunk_residuals = chunk_residuals  # list of [ctok_i, pd] mmaps
        self.chunk_doc_starts = chunk_doc_starts  # [nchunks+1] i64
        self.chunk_tok_starts = chunk_tok_starts  # [nchunks+1] i64
        self.doc_offsets = doc_offsets  # [nd(+pad)] i64, global token offs
        self.doclens = doclens  # [nd] i32

    def gather(self, doc_ids: np.ndarray):
        """Token rows for `doc_ids` (valid, any order) concatenated in the
        given doc order. Returns (codes [T] i32, residuals [T, pd] u8,
        lens [n] i32)."""
        ids = np.asarray(doc_ids, np.int64)
        lens = self.doclens[ids].astype(np.int64)
        total = int(lens.sum())
        pd = self.chunk_residuals[0].shape[1] if self.chunk_residuals else 0
        codes = np.empty(total, np.int32)
        res = np.empty((total, pd), np.uint8)
        chunk_of = np.searchsorted(self.chunk_doc_starts, ids, side="right") - 1
        out_offs = np.zeros(len(ids) + 1, np.int64)
        np.cumsum(lens, out=out_offs[1:])
        for c in np.unique(chunk_of):
            sel = np.nonzero(chunk_of == c)[0]
            local_start = self.doc_offsets[ids[sel]] - self.chunk_tok_starts[c]
            lsel = lens[sel]
            # Flat token index into chunk c for every selected doc's tokens.
            n_tok = int(lsel.sum())
            base = np.repeat(local_start, lsel)
            within = np.arange(n_tok, dtype=np.int64) - np.repeat(
                np.concatenate([[0], np.cumsum(lsel[:-1])]), lsel
            )
            tok_idx = base + within
            dst = np.repeat(out_offs[sel], lsel) + within
            codes[dst] = np.asarray(self.chunk_codes[c])[tok_idx]
            res[dst] = np.asarray(self.chunk_residuals[c])[tok_idx]
        return codes, res, lens.astype(np.int32)


def load_grid_only(
    index_path: str,
    dtype: str = "int8",
    buckets: int = 4,
    bucket_min_gain: float = 0.08,
    bucket_row_pad: int = 128,
    refine=True,
    device: DeviceLike = None,
) -> DeviceIndex:
    """Load an index for exact-only serving: stream the on-disk chunks
    through decompress (+ quantize for int8) into a pinned token grid, with
    the IVF never resident.

    `buckets` > 1 partitions docs into up to that many doclen buckets, each
    with its own Td (`choose_bucket_tds`), when that saves >= 8% of token
    slots; `buckets=1` forces one grid.

    `refine` configures the int8 grid's exact-rerank stage (next-plaid
    search.rs:460-493). True = "auto": codes/residuals resident on the
    device when they fit next to the grid, else gathered from the host;
    "device"/"host" force a side; False disables it. bf16 grids are already
    exact, so they never refine.

    The index serves `search_batch`/`search_batch_async` in exact mode only;
    other modes raise SearchError. Runs on `device` ("cuda" when None)."""
    device = resolve_device(device)
    layout = IndexLayout(index_path)
    meta = Metadata.from_dict(load_json(layout.metadata))
    if dtype not in ("bf16", "int8"):
        raise StorageError(f"grid-only dtype must be bf16|int8: {dtype}")

    def dev_f32(path):
        return _to_tensor(load_npy(path), torch.float32, device)

    centroids = dev_f32(layout.centroids)
    weights = dev_f32(layout.bucket_weights)
    dim = centroids.shape[1]
    packed_dim = dim * meta.nbits // 8

    doclens_list = [
        np.asarray(load_json(layout.chunk_doclens(i)), np.int64)
        for i in range(meta.num_chunks)
    ]
    doclens_all = (
        np.concatenate(doclens_list) if doclens_list else np.zeros(0, np.int64)
    ).astype(np.int32)
    nd = int(doclens_all.shape[0])
    n_emb = int(doclens_all.sum())
    max_doclen = int(doclens_all.max()) if nd else 0
    mult = 32 if dtype == "int8" else 8  # see _grid_td_for
    tile = 128
    tds = (
        choose_bucket_tds(
            doclens_all, mult, max_buckets=buckets, min_gain=bucket_min_gain,
            row_pad=bucket_row_pad,
        )
        if buckets > 1 and nd > 0
        else [_grid_td_for(max_doclen, dtype)]
    )

    nd_pad = _padded_doc_rows(nd)
    doclens_p = np.zeros(nd_pad, np.int32)
    doclens_p[:nd] = doclens_all
    doc_offsets = np.zeros(nd_pad + 1, np.int64)
    np.cumsum(doclens_p, out=doc_offsets[1:])

    if refine is True:
        refine_mode = "auto"
    elif refine in (False, None):
        refine_mode = "none"
    elif refine in ("auto", "host", "device"):
        refine_mode = refine
    else:
        raise StorageError(
            f"refine must be True/False/'auto'/'host'/'device': {refine!r}"
        )
    if nd == 0 or dtype != "int8":
        refine_mode = "none"
    refine_dev_bytes = n_emb * (4 + packed_dim)
    chunk_docs = [len(d) for d in doclens_list]
    chunk_tokens = [int(d.sum()) for d in doclens_list]
    slot_bytes = dim + 2 if dtype == "int8" else dim * 2
    # Peak transient of one chunk's build: its codes and residuals on the
    # device and one decompress tile's f32 temporaries.
    staging = (
        max(chunk_tokens, default=0) * (4 + packed_dim)
        + GRID_BUILD_TILE * max(tds) * dim * 4 * 4
        + (128 << 20)
    )

    # Row geometry of the JAX package (container.py nd_grid / rows_b), so
    # scores and grid_perm line up with it row for row. Its slack of
    # cdoc_pad + 128 rows keeps the XLA chunk writes (and the int8 group
    # rewrite, `_write_int8_groups`) from clamping; this package writes
    # doc-major rows in place and needs neither, but keeps the geometry.
    def cdoc_pad(counts):
        return max(_round_up(max(counts, default=1), tile), tile)

    if len(tds) == 1:
        rows = [
            _round_up(nd_pad + 512, tile) + cdoc_pad(chunk_docs) + 128
        ]
        bucket_of = np.zeros(nd, np.int64)
    else:
        per_doc_td = np.maximum(
            ((np.maximum(doclens_all.astype(np.int64), 1) + mult - 1) // mult)
            * mult,
            mult,
        )
        bucket_of = np.searchsorted(np.asarray(tds, np.int64), per_doc_td, side="left")
        chunk_starts = np.concatenate([[0], np.cumsum(chunk_docs)]).astype(np.int64)
        rows = []
        for b in range(len(tds)):
            in_b = bucket_of == b
            per_chunk = [
                int(np.count_nonzero(in_b[chunk_starts[i] : chunk_starts[i + 1]]))
                for i in range(meta.num_chunks)
            ]
            rows.append(
                max(_round_up(max(int(in_b.sum()), 1), tile), tile)
                + cdoc_pad(per_chunk)
                + 128
            )
    grid_bytes = sum(r * td for r, td in zip(rows, tds)) * slot_bytes
    side = refine_mode
    if side == "auto":
        limit = _device_hbm_bytes(device)
        fits = limit is None or grid_bytes + staging + refine_dev_bytes <= limit
        side = "device" if fits else "host"
    _require_grid_fits(
        grid_bytes + (refine_dev_bytes if side == "device" else 0), staging, device
    )

    grids = [
        torch.zeros(
            (r, td, dim),
            dtype=torch.int8 if dtype == "int8" else torch.bfloat16,
            device=device,
        )
        for r, td in zip(rows, tds)
    ]
    scale_grids = [
        torch.zeros((r, td), dtype=torch.bfloat16, device=device)
        for r, td in zip(rows, tds)
    ] if dtype == "int8" else []
    if side == "device":
        codes_all = torch.empty(n_emb, dtype=torch.int32, device=device)
        res_all = torch.empty((n_emb, packed_dim), dtype=torch.uint8, device=device)
    else:
        codes_all = torch.zeros(0, dtype=torch.int32, device=device)
        res_all = torch.zeros((0, packed_dim), dtype=torch.uint8, device=device)

    # One pass over the chunks: each is read from disk and staged on the
    # device once, and its docs' rows are written into their grid in place.
    rows_written = [0] * len(tds)
    tok0 = 0
    doc0 = 0
    for i in range(meta.num_chunks):
        codes_c = _to_tensor(load_npy(layout.chunk_codes(i)), torch.int32, device)
        res_c = _to_tensor(load_npy(layout.chunk_residuals(i)), torch.uint8, device)
        if side == "device":
            codes_all[tok0 : tok0 + codes_c.shape[0]] = codes_c
            res_all[tok0 : tok0 + codes_c.shape[0]] = res_c
        dl = doclens_list[i]
        offs = np.zeros(len(dl), np.int64)
        np.cumsum(dl[:-1], out=offs[1:])
        in_chunk = bucket_of[doc0 : doc0 + len(dl)]
        for b, td in enumerate(tds):
            local = np.nonzero(in_chunk == b)[0]
            for s in range(0, len(local), GRID_BUILD_TILE):
                sel = local[s : s + GRID_BUILD_TILE]
                lens = torch.from_numpy(dl[sel]).to(device)
                emb = decompress_windows(
                    codes_c, res_c, torch.from_numpy(offs[sel]).to(device), lens,
                    td, centroids, weights, meta.nbits,
                )
                r0 = rows_written[b]
                if dtype == "int8":
                    valid = torch.arange(td, device=device)[None, :] < lens[:, None]
                    q, sc = quantize_tokens_int8(emb, valid)
                    grids[b][r0 : r0 + len(sel)] = q
                    scale_grids[b][r0 : r0 + len(sel)] = sc
                else:
                    grids[b][r0 : r0 + len(sel)] = emb.to(torch.bfloat16)
                rows_written[b] += len(sel)
        tok0 += codes_c.shape[0]
        doc0 += len(dl)
        del codes_c, res_c

    refine_host = None
    if side == "host":
        cds = np.zeros(meta.num_chunks + 1, np.int64)
        cts = np.zeros(meta.num_chunks + 1, np.int64)
        np.cumsum(chunk_docs, out=cds[1:])
        np.cumsum(chunk_tokens, out=cts[1:])
        refine_host = HostRefineData(
            chunk_codes=[load_npy(layout.chunk_codes(i)) for i in range(meta.num_chunks)],
            chunk_residuals=[
                load_npy(layout.chunk_residuals(i)) for i in range(meta.num_chunks)
            ],
            chunk_doc_starts=cds,
            chunk_tok_starts=cts,
            doc_offsets=doc_offsets,
            doclens=doclens_all,
        )

    common = dict(
        centroids=centroids,
        codes=codes_all,
        residuals=res_all,
        doc_offsets=_to_tensor(doc_offsets, torch.int32, device),
        doclens=_to_tensor(doclens_p, torch.int32, device),
        ivf_offsets=torch.zeros(centroids.shape[0] + 1, dtype=torch.int32, device=device),
        ivf_doc_ids=torch.zeros(0, dtype=torch.int32, device=device),
        bucket_cutoffs=dev_f32(layout.bucket_cutoffs),
        bucket_weights=weights,
        avg_residual=dev_f32(layout.avg_residual),
        n_docs=nd,
        n_emb=n_emb,
        nbits=meta.nbits,
        max_doclen=max_doclen,
        grid_only=True,
        refine_host=refine_host,
    )
    if len(tds) == 1:
        return DeviceIndex(
            token_grid=grids[0],
            token_scales=scale_grids[0] if scale_grids else None,
            **common,
        )
    perm_parts, len_parts = [], []
    for b, r in enumerate(rows):
        ids = np.nonzero(bucket_of == b)[0].astype(np.int32)
        perm_b = np.full(r, -1, np.int32)
        perm_b[: len(ids)] = ids
        perm_parts.append(perm_b)
        lens_b = np.zeros(r, np.int32)
        lens_b[: len(ids)] = doclens_all[ids]
        len_parts.append(lens_b)
    return DeviceIndex(
        grid_buckets=tuple(grids),
        scale_buckets=tuple(scale_grids),
        grid_perm=_to_tensor(np.concatenate(perm_parts), torch.int32, device),
        grid_doclens=_to_tensor(np.concatenate(len_parts), torch.int32, device),
        **common,
    )
