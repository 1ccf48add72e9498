"""The comparison that decides `correct`.

The served answers (top-k ids and scores, as the timed path returned them)
are held against the plain reference (`benchmark/reference/plaid.py`), run
once the window has closed over the index the build wrote:

- `missing`: answers with fewer than top_k ids, an id out of range, a
  repeated id or a score that is not finite. Limit 0.
- `score_err_mean`, `score_err_max`: |served score - the reference's f32
  score of the same document|, over every (query, rank) compared.
- `rank_err_mean`: |served score at rank r - the reference answer's score
  at rank r|, over every (query, rank) compared. The reference answer is
  the exact top-k (exact routes) or the top-k of the staged pool the
  reference worked out for the same batch (the staged route). It sees
  answers that hold the wrong documents under their own true scores,
  which `score_err_*` cannot.
- `rank_gap_max`: the widest gap by which a served document's f32 score
  lies below the reference answer's at the same rank.
The build is checked by itself, since the reference follows the program
from the index it wrote (its centroids, cutoffs and weights), on a sample
of the original tokens drawn from the seed:
- `build_mismatches`: stored doc lengths = the inputs', the stored
  inverted file = the one worked out from the codes, each sampled code =
  the nearest centroid of the original token and each residual bucket =
  the bucket of (token - centroid) under the stored cutoffs, near-ties of
  rounding (within CODE_TIE / BUCKET_TIE) skipped. Limit 0.
- `codec_quantile_err`: the stored cutoffs and weights against the
  quantiles of the sampled residual values that define them.
- `kmeans_excess`: the k-means fit of the stored centroids, as the
  sampled tokens' mean squared residual over that to their own topic,
  which the benchmark knows because it drew them, less 1.

Which numbers decide, and their limits, are the traffic mix's `limits`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from plaidbench import corpus
from reference import plaid

CODE_TIE = 1e-5  # top-2 centroid scores closer than this may flip by rounding
BUCKET_TIE = 1e-6  # residual values this close to a cutoff may flip
BUILD_SAMPLE_TOKENS = 65536

Answer = Tuple[Sequence[int], Sequence[float]]


class Tally:
    """Numbers accumulated over the compared answers."""

    def __init__(self) -> None:
        self.missing = 0
        self.errs: List[np.ndarray] = []
        self.rank_errs: List[np.ndarray] = []
        self.gap = 0.0
        self.hits = 0
        self.compared = 0

    def add(self, answer: Answer, ref_row: np.ndarray, ref_ids: np.ndarray,
            served_ref: Dict[int, float], top_k: int, n_docs: int) -> None:
        ids = [int(i) for i in answer[0]]
        scores = np.asarray(answer[1], np.float64)
        want = min(top_k, n_docs)
        bad = (
            len(ids) != want or len(scores) != len(ids) or len(set(ids)) != len(ids)
            or any(i < 0 or i >= n_docs for i in ids) or not np.all(np.isfinite(scores))
        )
        self.compared += 1
        if bad:
            self.missing += 1
            return
        truth = np.asarray([served_ref[i] for i in ids], np.float64)
        self.errs.append(np.abs(scores - truth))
        self.rank_errs.append(np.abs(scores - ref_row[: len(ids)]))
        self.gap = max(self.gap, float(np.max(ref_row[: len(ids)] - truth)))
        self.hits += len(set(ids) & set(int(i) for i in ref_ids[:want]))

    def numbers(self, top_k: int) -> Dict[str, float]:
        err = np.concatenate(self.errs) if self.errs else np.zeros(1)
        rank_err = np.concatenate(self.rank_errs) if self.rank_errs else np.zeros(1)
        return {
            "missing": float(self.missing),
            "score_err_mean": float(err.mean()),
            "score_err_max": float(err.max()),
            "rank_err_mean": float(rank_err.mean()),
            "rank_gap_max": self.gap,
            "recall_at_k": self.hits / max(1, self.compared * top_k),
            "compared": float(self.compared),
        }


def _ids_tensor(ids: Sequence[int], n_docs: int, device) -> torch.Tensor:
    ok = [int(i) for i in ids if 0 <= int(i) < n_docs]
    return torch.tensor(ok, dtype=torch.int64, device=device)


def check_exact(files: plaid.IndexFiles, queries: Sequence[np.ndarray],
                answers: Sequence[Answer], top_k: int) -> Dict[str, float]:
    """Answers of the exact routes against the exact f32 top-k."""
    scores = plaid.exact_scores(files, queries)
    ref_ids, ref_scores = plaid.topk(scores, torch.arange(files.num_docs, device=files.device), top_k)
    tally = Tally()
    for i, ans in enumerate(answers):
        served = _ids_tensor(ans[0], files.num_docs, files.device)
        row = scores[i, served].cpu().numpy()
        tally.add(ans, ref_scores[i], ref_ids[i], dict(zip(served.tolist(), row)), top_k, files.num_docs)
    return tally.numbers(top_k)


def check_staged(files: plaid.IndexFiles, ivf, batches: Sequence[Sequence[np.ndarray]],
                 answers: Sequence[Sequence[Answer]], search: dict) -> Dict[str, float]:
    """Answers of the staged route, batch by batch, against the top-k of the
    staged pool the reference works out for the same batch."""
    top_k = int(search["top_k"])
    tally = Tally()
    for batch, batch_answers in zip(batches, answers):
        _, union, _ = plaid.staged_search(files, ivf, batch, search, pool_scores=False)
        served = torch.cat([_ids_tensor(a[0], files.num_docs, files.device) for a in batch_answers])
        docs = torch.unique(torch.cat([union, served]))
        scores = plaid.exact_scores(files, batch, docs=docs)
        in_union = torch.isin(docs, union)
        ref_ids, ref_scores = plaid.topk(scores[:, in_union], docs[in_union], top_k)
        col = {d: j for j, d in enumerate(docs.tolist())}
        host = scores.cpu().numpy()
        for i, ans in enumerate(batch_answers):
            look = {d: host[i, col[d]] for d in (int(x) for x in ans[0]) if d in col}
            tally.add(ans, ref_scores[i], ref_ids[i], look, top_k, files.num_docs)
    return tally.numbers(top_k)


def reference_answers(files: plaid.IndexFiles, ivf, batches: Sequence[Sequence[np.ndarray]],
                      search: dict, precision: str, staged: bool) -> List[List[Answer]]:
    """The reference put in the program's place at `precision`: the
    benchmark's controls."""
    out = []
    top_k = int(search["top_k"])
    for batch in batches:
        if staged:
            _, union, scores = plaid.staged_search(files, ivf, batch, search, precision)
            ids, sc = plaid.topk(scores, union, top_k)
        else:
            scores = plaid.exact_scores(files, batch, precision)
            ids, sc = plaid.topk(scores, torch.arange(files.num_docs, device=files.device), top_k)
        out.append([(list(ids[i]), list(sc[i])) for i in range(len(batch))])
    return out


def build_check(files: plaid.IndexFiles, cfg: dict, seed: int, lens: np.ndarray,
                ivf, device: torch.device) -> Dict[str, float]:
    """The build checked by itself (module docstring): `build_mismatches`,
    `codec_quantile_err` and `kmeans_excess`."""
    bad = 1 if files.doclens.shape != lens.shape else int(np.sum(files.doclens != lens))
    if bad:  # the token sample below would not line up
        return {"build_mismatches": float(bad), "codec_quantile_err": 1.0, "kmeans_excess": 1.0}
    docs, offsets = ivf
    lengths = (offsets[1:] - offsets[:-1]).cpu().numpy()
    if not np.array_equal(lengths, files.stored_ivf_lengths):
        bad += int(np.sum(lengths != files.stored_ivf_lengths))
    elif not np.array_equal(docs.cpu().numpy(), files.stored_ivf):
        bad += int(np.sum(docs.cpu().numpy() != files.stored_ivf))
    pos = _sample_positions(lens, seed)
    toks, topic = corpus.corpus_rows(cfg, lens, seed, device, pos)
    cent = files.centroids
    best, nearest = _nearest(toks, cent, 2)
    clear = (best[:, 0] - best[:, -1] > CODE_TIE) | (cent.shape[0] == 1)
    pos_t = torch.from_numpy(pos).to(device)
    stored = files.codes[pos_t]
    bad += int(((nearest[:, 0] != stored) & clear).sum())
    resid = toks - cent[stored]
    want = torch.searchsorted(files.cutoffs.contiguous(), resid.contiguous(), right=False)
    near = (resid[..., None] - files.cutoffs).abs().amin(dim=-1) < BUCKET_TIE
    bad += int(((want != files.buckets(pos_t)) & ~near).sum())
    return {
        "build_mismatches": float(bad),
        "codec_quantile_err": quantile_err(resid, files.cutoffs, files.weights),
        "kmeans_excess": kmeans_excess(toks, resid, topic),
    }


def build_faults(files: plaid.IndexFiles, cfg: dict, seed: int, lens: np.ndarray,
                 device: torch.device) -> Dict[str, float]:
    """The build's two numbers under the faults they are there to catch, on
    the same seeded sample: `codec_quantile_err` of bucket weights written
    at the buckets' edges instead of their midpoints, and `kmeans_excess` of
    centroids that skipped k-means (the unit tokens the build draws as its
    initial centroids: index seed, a permutation of all token rows)."""
    pos = _sample_positions(lens, seed)
    toks, topic = corpus.corpus_rows(cfg, lens, seed, device, pos)
    resid = toks - files.centroids[files.codes[torch.from_numpy(pos).to(device)]]
    n_opt = files.weights.numel()
    flat = torch.sort(resid.reshape(-1)).values
    edge_weights = flat[torch.arange(n_opt, device=device) * (flat.numel() - 1) // n_opt]
    k = int(files.centroids.shape[0])
    init = np.random.default_rng(int(cfg["index_seed"])).permutation(int(lens.sum()))[:k]
    c0, _ = corpus.corpus_rows(cfg, lens, seed, device, init)
    c0 = c0 / c0.norm(dim=1, keepdim=True).clamp(min=1e-12)
    skipped = toks - c0[_nearest(toks, c0, 1)[1][:, 0]]
    return {
        "codec_quantile_err": quantile_err(resid, files.cutoffs, edge_weights),
        "kmeans_excess": kmeans_excess(toks, skipped, topic),
    }


def _sample_positions(lens: np.ndarray, seed: int) -> np.ndarray:
    total = int(lens.sum())
    rng = np.random.default_rng(corpus.sub_seed(seed, "build-check"))
    return np.sort(rng.choice(total, size=min(BUILD_SAMPLE_TOKENS, total), replace=False))


def _nearest(toks: torch.Tensor, cent: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `n` best centroid scores and ids of each token by dot product, in
    row blocks that keep the [rows, K] f32 scores near 2 GB."""
    rows = max(1, (1 << 29) // max(1, cent.shape[0]))
    parts = [torch.topk(toks[s : s + rows] @ cent.T, min(n, cent.shape[0]), dim=1)
             for s in range(0, toks.shape[0], rows)]
    return torch.cat([p.values for p in parts]), torch.cat([p.indices for p in parts])


def quantile_err(resid: torch.Tensor, cutoffs: torch.Tensor, weights: torch.Tensor) -> float:
    """The widest gap between the share of sampled residual values below a
    stored table entry and the quantile that defines it: cutoff i at
    i / 2^nbits, weight i at (i + 1/2) / 2^nbits (the codec's rule); 1.0
    when the tables do not have 2^nbits - 1 and 2^nbits entries."""
    n_opt = weights.numel()
    if cutoffs.numel() != n_opt - 1 or n_opt < 2:
        return 1.0
    flat = torch.sort(resid.reshape(-1).float()).values
    table = torch.cat([cutoffs, weights]).float().contiguous()
    i = torch.arange(n_opt, dtype=torch.float64, device=flat.device)
    levels = torch.cat([i[1:] / n_opt, (i + 0.5) / n_opt])
    below = (torch.searchsorted(flat, table, right=False) + torch.searchsorted(flat, table, right=True))
    share = below.double() / (2 * flat.numel())
    return float((share - levels).abs().max())


def kmeans_excess(toks: torch.Tensor, resid: torch.Tensor, topic: torch.Tensor) -> float:
    """Mean squared residual to the stored centroids over that to each
    token's own unit topic, less 1: about 0 for centroids k-means fit to
    the topics, well above it for centroids that do not fit the corpus."""
    own = (toks - topic).pow(2).sum(dim=1).double().mean()
    return float(resid.pow(2).sum(dim=1).double().mean() / own - 1.0)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each limited number beside its limit, and whether all hold."""
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": v} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
