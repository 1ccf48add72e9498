"""Plain reference of exact and staged (PLAID) MaxSim search over an index
directory, in f32 with TF32 off.

What it reads is the index as the build wrote it, in next-plaid's format
(src/codec.rs, src/index.rs): `centroids.npy`, `bucket_cutoffs.npy`,
`bucket_weights.npy`, `{i}.codes.npy`, `{i}.residuals.npy` (each value's
bucket written LSB-first into an MSB-first bitstream), `doclens.{i}.json`,
`ivf.npy` and `ivf_lengths.npy`. A token decompresses to
unit(centroid[code] + bucket_weight[bucket]). The reference builds its own
inverted file from the codes; the stored one is only compared with it.

Exact search: sum over query tokens of the max over a document's tokens of
the dot product, every document scored. Staged search, as PLAID defines
it (arXiv:2205.09707; next-plaid src/search.rs:327-516) at the port's
batch scope:
  1. centroid scores S = q . C for every query token;
  2. each token's `nprobe` best cells, kept when the cell's best score over
     all the query's tokens reaches `threshold`; a cell probed by several
     tokens weighs the sum of their scores;
  3. each document's approximate score is the sum of the weights of the
     selected cells it has a token in; the `pool` best documents survive
     (ties to the lower doc id);
  3b. ("codes") each survivor is re-scored as sum over query tokens of the
     max over its tokens of S[token, code]; the `keep` best survive (ties
     in the order of step 3);
  4. the batch's survivors are pooled, and every query of the batch is
     scored exactly against the pool; the best `top_k` are its answer.

`precision` computes the exact scores in a lower precision, for the
benchmark's controls: "int8" and "int4" quantize each query and document
token symmetrically (scale = max |x| / 127 or / 7, round half to even),
take the integer products exactly and rescale.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# Padded document token rows decompressed and scored per step: with 2,048
# query token rows the [rows, block] f32 similarities stay near 1 GB.
TOKEN_BLOCK = 1 << 17
QMAX = {"int8": 127.0, "int4": 7.0}


def no_tf32() -> None:
    """f32 products must not drop to TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class IndexFiles:
    """The arrays of one index directory, on `device`."""

    def __init__(self, path: str, device: torch.device):
        no_tf32()

        def npy(name: str) -> np.ndarray:
            return np.load(os.path.join(path, name))

        def js(name: str):
            with open(os.path.join(path, name)) as f:
                return json.load(f)

        meta = js("metadata.json")
        self.nbits = int(meta["nbits"])
        chunks = range(int(meta["num_chunks"]))
        self.device = device
        self.centroids = torch.from_numpy(npy("centroids.npy").astype(np.float32)).to(device)
        self.cutoffs = torch.from_numpy(npy("bucket_cutoffs.npy").astype(np.float32)).to(device)
        self.weights = torch.from_numpy(npy("bucket_weights.npy").astype(np.float32)).to(device)
        self.codes = torch.from_numpy(
            np.concatenate([npy(f"{i}.codes.npy") for i in chunks]).astype(np.int64)
        ).to(device)
        self.residuals = torch.from_numpy(
            np.concatenate([npy(f"{i}.residuals.npy") for i in chunks])
        ).to(device)
        self.doclens = np.asarray(
            [n for i in chunks for n in js(f"doclens.{i}.json")], np.int64
        )
        self.stored_ivf = npy("ivf.npy").astype(np.int64)
        self.stored_ivf_lengths = npy("ivf_lengths.npy").astype(np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.doclens)])
        self.lens_t = torch.from_numpy(self.doclens).to(device)
        self.offsets_t = torch.from_numpy(self.offsets).to(device)
        self.max_len = int(self.doclens.max())
        self.dim = int(self.centroids.shape[1])
        self.num_docs = int(self.doclens.shape[0])

    def buckets(self, tok: torch.Tensor) -> torch.Tensor:
        """Bucket indices [n, d] of the tokens at positions `tok` [n]."""
        nbits = self.nbits
        per = 8 // nbits
        rev = torch.tensor(
            [int(format(v, f"0{nbits}b")[::-1], 2) for v in range(1 << nbits)],
            device=self.device,
        )
        packed = self.residuals[tok].long()  # [n, d * nbits / 8]
        shifts = torch.tensor([8 - nbits * (k + 1) for k in range(per)], device=self.device)
        seg = (packed[..., None] >> shifts) & ((1 << nbits) - 1)
        return rev[seg].reshape(*packed.shape[:-1], -1)

    def decompress(self, tok: torch.Tensor) -> torch.Tensor:
        """Unit token vectors [..., d] f32 at positions `tok` [...]."""
        flat = tok.reshape(-1)
        emb = self.centroids[self.codes[flat]] + self.weights[self.buckets(flat)]
        emb = emb / torch.clamp(emb.norm(dim=-1, keepdim=True), min=1e-12)
        return emb.reshape(*tok.shape, self.dim)

    def padded_docs(self, docs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token positions [n, max_len] of `docs` and their validity mask."""
        ar = torch.arange(self.max_len, device=self.device)
        valid = ar[None, :] < self.lens_t[docs][:, None]
        pos = torch.clamp(self.offsets_t[docs][:, None] + ar[None, :], max=self.codes.shape[0] - 1)
        return pos, valid

    def ivf(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inverted file worked out from the codes: each cell's documents,
        ascending and deduplicated, as (doc ids [nnz], offsets [K + 1])."""
        k = int(self.centroids.shape[0])
        doc = torch.repeat_interleave(
            torch.arange(self.num_docs, device=self.device), self.lens_t
        )
        key = torch.unique(self.codes * self.num_docs + doc)
        cells, docs = key // self.num_docs, key % self.num_docs
        lengths = torch.bincount(cells, minlength=k)
        offsets = torch.zeros(k + 1, dtype=torch.int64, device=self.device)
        offsets[1:] = torch.cumsum(lengths, 0)
        return docs, offsets


def quantize(x: torch.Tensor, precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, per-row scale) of `x` [..., d] at `precision`: f32 as it is,
    or integers held in f32 with their scale."""
    if precision == "f32":
        return x, torch.ones(x.shape[:-1], device=x.device)
    qmax = QMAX[precision]
    maxabs = x.abs().amax(dim=-1)
    scale = torch.where(maxabs > 0, maxabs / qmax, torch.ones_like(maxabs))
    return torch.clamp(torch.round(x / scale[..., None]), -qmax, qmax), scale


def exact_scores(
    files: IndexFiles,
    queries: Sequence[np.ndarray],
    precision: str = "f32",
    docs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MaxSim scores [Q, n] of every query against `docs` (every document
    when None), computed in blocks of padded documents."""
    dev = files.device
    if docs is None:
        docs = torch.arange(files.num_docs, device=dev)
    q_n = len(queries)
    tq = max(int(q.shape[0]) for q in queries)
    qt = torch.zeros((q_n, tq, files.dim), device=dev)
    qmask = torch.zeros((q_n, tq), dtype=torch.bool, device=dev)
    for i, q in enumerate(queries):
        qt[i, : q.shape[0]] = torch.from_numpy(np.asarray(q, np.float32)).to(dev)
        qmask[i, : q.shape[0]] = True
    qv, qs = quantize(qt.reshape(q_n * tq, files.dim), precision)
    out = torch.empty((q_n, docs.shape[0]), device=dev)
    step = max(1, TOKEN_BLOCK // files.max_len)
    for s in range(0, docs.shape[0], step):
        block = docs[s : s + step]
        pos, valid = files.padded_docs(block)
        tv, ts = quantize(files.decompress(pos), precision)  # [n, L, d], [n, L]
        sims = (qv @ tv.reshape(-1, files.dim).T) * qs[:, None] * ts.reshape(1, -1)
        sims = sims.view(q_n * tq, block.shape[0], files.max_len)
        best = sims.masked_fill(~valid[None], float("-inf")).amax(dim=2)
        best = torch.where(qmask.reshape(-1, 1), best, torch.zeros((), device=dev))
        out[:, s : s + block.shape[0]] = best.view(q_n, tq, -1).sum(dim=1)
    return out


def _best_first(scores: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The `n` ids of highest score, ties kept in the order of `ids`."""
    order = torch.sort(-scores, stable=True).indices
    return ids[order[:n]]


def staged_survivors(
    files: IndexFiles,
    ivf: Tuple[torch.Tensor, torch.Tensor],
    query: np.ndarray,
    nprobe: int,
    threshold: Optional[float],
    pool: int,
    keep: int,
    approx: str = "codes",
) -> torch.Tensor:
    """Steps 1-3b for one query: the doc ids that reach the exact re-rank."""
    dev = files.device
    ivf_docs, ivf_off = ivf
    q = torch.from_numpy(np.asarray(query, np.float32)).to(dev)
    s = q @ files.centroids.T  # [Tq, K]
    vals, cells = torch.topk(s, min(nprobe, s.shape[1]), dim=1)
    ok = torch.isfinite(vals)
    if threshold is not None:
        ok &= s.amax(dim=0)[cells] >= threshold
    k = s.shape[1]
    weight = torch.zeros(k, dtype=torch.float64, device=dev)
    weight.index_add_(0, cells[ok], vals[ok].double())
    sel = torch.unique(cells[ok])
    w32 = weight.float()
    lens = ivf_off[sel + 1] - ivf_off[sel]
    entry_cell = torch.repeat_interleave(sel, lens)
    first = torch.repeat_interleave(ivf_off[sel], lens)
    within = torch.arange(entry_cell.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens
    )
    docs = ivf_docs[first + within]
    approx_s = torch.zeros(files.num_docs, dtype=torch.float64, device=dev)
    approx_s.index_add_(0, docs, w32[entry_cell].double())
    hit = torch.zeros(files.num_docs, dtype=torch.bool, device=dev)
    hit[docs] = True
    cand = torch.nonzero(hit).reshape(-1)  # ascending doc ids
    pooled = _best_first(approx_s.float()[cand], cand, pool)
    if approx != "codes":
        return pooled[:keep]
    pos, valid = files.padded_docs(pooled)
    g = s[:, files.codes[pos]]  # [Tq, n, L]
    g = g.masked_fill(~valid[None], float("-inf")).amax(dim=2)
    return _best_first(g.sum(dim=0), pooled, keep)


def staged_search(
    files: IndexFiles,
    ivf: Tuple[torch.Tensor, torch.Tensor],
    batch: Sequence[np.ndarray],
    search: dict,
    precision: str = "f32",
    pool_scores: bool = True,
) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """Staged search of one batch: (each query's survivors, the batch's
    pool of doc ids [n] ascending, exact scores [Q, n] over that pool, or
    None without `pool_scores`)."""
    keep = int(search["n_full_scores"]) // 4
    pool = int(search["n_full_scores"]) if search.get("approx_score", "codes") == "codes" else keep
    surv = [
        staged_survivors(
            files, ivf, q, int(search["n_ivf_probe"]), search.get("centroid_score_threshold"),
            pool, keep, search.get("approx_score", "codes"),
        )
        for q in batch
    ]
    union = torch.unique(torch.cat(surv))
    if not pool_scores:
        return surv, union, None
    return surv, union, exact_scores(files, batch, precision, docs=union)


def topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each row's best `k` (ids [Q, k], scores [Q, k]), ties to the lower id."""
    order = torch.sort(ids).indices
    s, i = scores[:, order], ids[order]
    best = torch.sort(-s, dim=1, stable=True).indices[:, :k]
    return i[best].cpu().numpy(), torch.gather(s, 1, best).cpu().numpy()
