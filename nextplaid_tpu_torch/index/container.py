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
  token_grid     [ND_grid, Td, d]  bf16  (optional pinned decompressed corpus)

The on-disk representation is next-plaid's chunked NPY + JSON directory
(src/index.rs:373-528), so indexes are interchangeable with the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from nextplaid_tpu_torch.index.config import Metadata
from nextplaid_tpu_torch.ops import codec as codec_ops
from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json, load_npy
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device

# Padding of the doc and token axes, as in the JAX package.
PAD_DOCS = 8
PAD_TOKENS = 128

# Docs decompressed per step while the token grid is built: bounds the f32
# temporary to GRID_BUILD_TILE * Td * d * 4 bytes (80 MB at Td 304, d 128).
GRID_BUILD_TILE = 512

_INT8_DEFERRED = (
    "int8 token grids are not ported yet (ROADMAP.md, int8 grid slice)"
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


def _padded_doc_rows(ndocs: int) -> int:
    """Doc rows after padding: +1 sentinel slot (doclen 0), rounded up to
    PAD_DOCS."""
    return _round_up(ndocs + 1, PAD_DOCS)


def _grid_rows_for(nd_pad: int, tile: int = 64) -> int:
    """Rows of the pinned grid: the JAX package's layout, 512 slack rows
    past the padded doc rows, rounded up to its 64-doc build tile."""
    return _round_up(nd_pad + 512, tile)


def _to_tensor(x: np.ndarray, dtype: torch.dtype, device: torch.device):
    # A copy: loaded arrays are read-only memory maps.
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


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
    # Optional pinned decompressed corpus [ND_grid, Td, d] bf16, token rows
    # at or beyond a doc's length zeroed.
    token_grid: Optional[torch.Tensor] = None
    n_docs: int = 0
    n_emb: int = 0
    nbits: int = 4
    max_doclen: int = 0

    @property
    def num_documents(self) -> int:
        return self.n_docs

    @property
    def num_embeddings(self) -> int:
        return self.n_emb

    @property
    def num_centroids(self) -> int:
        return self.centroids.shape[0]

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

    def token_axis(self) -> int:
        """Td that exact scoring walks: the pinned grid's token axis, else
        max_doclen padded as a bf16 grid's would be."""
        if self.token_grid is not None:
            return self.token_grid.shape[1]
        return self.grid_td("bf16")

    @property
    def has_grid(self) -> bool:
        return self.token_grid is not None

    def grid_bytes(self, dtype: str = "bf16") -> int:
        return _grid_bytes_for(
            self.num_docs_padded, self.max_doclen, self.dim, dtype
        )

    def with_token_grid(
        self, budget_mb: Optional[int] = None, dtype: Optional[str] = None
    ) -> "DeviceIndex":
        """Return a copy carrying the decompressed bf16 [ND_grid, Td, d]
        token grid, or self unchanged if the grid exceeds the budget
        (NEXT_PLAID_PIN_BUDGET_MB, default 4096).

        dtype (or NEXT_PLAID_PIN_DTYPE): "bf16" or "auto" (the default),
        which pins bf16 when it fits. Where the JAX package would pin an int8
        grid instead (an "int8" request, or "auto" with only the int8 grid
        under budget), this raises NotImplementedError.
        """
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
        if dtype == "int8":
            raise NotImplementedError(_INT8_DEFERRED)
        budget = budget_mb << 20
        if self.grid_bytes("bf16") > budget:
            if dtype == "auto" and self.grid_bytes("int8") <= budget:
                raise NotImplementedError(
                    f"the bf16 grid needs {self.grid_bytes('bf16') >> 20} MB "
                    f"> budget {budget_mb} MB and the JAX package would pin "
                    f"int8 here: {_INT8_DEFERRED}"
                )
            return self
        grid = _build_token_grid(self, self.grid_td("bf16"))
        return dataclasses.replace(self, token_grid=grid)

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
        device: DeviceLike = None,
    ) -> "DeviceIndex":
        """Pad host arrays as the JAX package does and stage them on
        `device` ("cuda" when None)."""
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
        ndocs_pad = _padded_doc_rows(ndocs)
        nvec_pad = max(_round_up(nvec, PAD_TOKENS), PAD_TOKENS)
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
    ) -> "DeviceIndex":
        """Build the index from the padded arrays of a `nextplaid_tpu`
        DeviceIndex, converted to numpy, so both packages score the same
        state. `arrays` holds the tensor fields by name (centroids, codes,
        residuals, doc_offsets, doclens, ivf_offsets, ivf_doc_ids,
        bucket_cutoffs, bucket_weights, avg_residual) and optionally a bf16
        `token_grid` (given as bfloat16 or as float32 holding bf16 values).
        """
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
        grid = arrays.get("token_grid")
        if grid is not None:
            grid = np.asarray(grid)
            if grid.dtype == np.int8 or "token_scales" in arrays:
                raise NotImplementedError(_INT8_DEFERRED)
            # numpy has no bfloat16 of its own (JAX hands out ml_dtypes').
            grid = _to_tensor(grid.astype(np.float32), torch.bfloat16, device)
        return cls(
            **fields,
            token_grid=grid,
            n_docs=int(num_documents),
            n_emb=int(num_embeddings),
            nbits=int(nbits),
            max_doclen=int(max_doclen),
        )

    @classmethod
    def load(cls, index_path: str, device: DeviceLike = None) -> "DeviceIndex":
        """Load an index directory (next-plaid `MmapIndex::load`,
        src/index.rs:1026) onto `device` ("cuda" when None)."""
        device = resolve_device(device)
        h = load_host_arrays(index_path)
        return cls.from_host(
            centroids=h["centroids"],
            codes=h["codes"],
            residuals=h["residuals"],
            doclens=h["doclens"],
            ivf_lengths=h["ivf_lengths"],
            ivf_doc_ids=h["ivf"],
            bucket_cutoffs=h["bucket_cutoffs"],
            bucket_weights=h["bucket_weights"],
            avg_residual=h["avg_residual"],
            nbits=h["meta"].nbits,
            device=device,
        )


def load_grid_only(*args, **kwargs) -> DeviceIndex:
    """Grid-only serving is not ported yet (ROADMAP.md, int8 grid slice)."""
    raise NotImplementedError(
        "load_grid_only is not ported yet (ROADMAP.md, int8 grid slice)"
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


def decompress_docs(
    index: DeviceIndex, doc_ids: torch.Tensor, td: int
) -> torch.Tensor:
    """Decompressed, renormalized tokens of `doc_ids` as [n, td, d] f32, with
    token rows at or beyond each doc's length zeroed. Ids past the padded
    doc rows read as empty docs."""
    nd_pad = index.num_docs_padded
    nvec_pad = index.codes.shape[0]
    safe = torch.clamp(doc_ids, max=nd_pad - 1).long()
    lens = torch.where(doc_ids < nd_pad, index.doclens[safe], 0)
    t_ar = torch.arange(td, device=doc_ids.device)
    tok_pos = torch.clamp(
        index.doc_offsets[safe].long()[:, None] + t_ar[None, :], 0, nvec_pad - 1
    )
    emb = codec_ops.decompress_residuals(
        index.residuals[tok_pos],
        index.codes[tok_pos],
        index.centroids,
        index.bucket_weights,
        index.nbits,
        normalize=True,
    )
    valid = t_ar[None, :] < lens[:, None]
    return torch.where(valid[:, :, None], emb, torch.zeros((), device=emb.device))


def _build_token_grid(index: DeviceIndex, td: int) -> torch.Tensor:
    """Decompress the whole corpus once into the padded bf16 token grid
    [ND_grid, td, d] (the JAX package's `_build_token_grid`, same rows)."""
    nd_grid = _grid_rows_for(index.num_docs_padded)
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
