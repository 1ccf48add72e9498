"""Corpus and query generators, frozen copies of the program's own.

`doclens` reproduces `bench_torch.py:make_doclens` (SciFact's shape: normal
290 +- 40 clipped to 64-300, numpy seed 0 -> 1,441,163 tokens for 5,183
docs) and the megascale generator's lengths (`chip_smoke.py:mega_corpus`:
uniform 100-220 from numpy seed 1). The multiset of lengths comes from the
configuration's fixed `shape_seed`, and the run's seed only permutes it, so
every seed does the same amount of work. `corpus_device` is
`bench_torch.py:make_corpus_device` (unit(topic + noise) tokens made on the
device from a `torch.Generator`), written in chunks so that a 19M-token
corpus never holds more than one chunk of temporaries (`corpus_rows` draws
the same stream and keeps some rows, with the topic of each); `queries` is
`bench_torch.py:make_queries`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# Tokens generated per call: the gather and noise temporaries of one chunk
# stay near 1 GB at d 128.
CORPUS_CHUNK_TOKENS = 1 << 21


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream.encode()])
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def doclens(cfg: dict, seed: int) -> np.ndarray:
    """Document lengths [documents] int64: the configuration's fixed multiset
    of lengths in an order drawn from `seed`."""
    spec = cfg["doclens"]
    n = int(cfg["documents"])
    rng = np.random.default_rng(spec["shape_seed"])
    if spec["kind"] == "normal_clipped":
        lens = np.clip(rng.normal(spec["mean"], spec["std"], n), spec["min"], spec["max"])
    elif spec["kind"] == "uniform":
        lens = rng.integers(spec["min"], spec["max"] + 1, size=n)
    else:
        raise ValueError(f"unknown doclens kind {spec['kind']!r}")
    lens = lens.astype(np.int64)
    return lens[np.random.default_rng(sub_seed(seed, "doclens")).permutation(n)]


def _stream(cfg: dict, lens: np.ndarray, seed: int, device: torch.device):
    """The corpus's random stream: first the unit topics [topics, dim], then
    per chunk (first token position, topic ids [n], unit tokens [n, dim])."""
    dim, n_topics, noise = int(cfg["dim"]), int(cfg["topics"]), float(cfg["noise"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "corpus"))
    topics = torch.randn(n_topics, dim, generator=gen, device=device)
    topics = topics / topics.norm(dim=1, keepdim=True)
    yield topics
    total = int(np.sum(lens))
    for s in range(0, total, CORPUS_CHUNK_TOKENS):
        n = min(CORPUS_CHUNK_TOKENS, total - s)
        ids = torch.randint(0, n_topics, (n,), generator=gen, device=device)
        v = topics[ids] + noise * torch.randn(n, dim, generator=gen, device=device)
        v = v / v.norm(dim=1, keepdim=True)  # rebound, so one chunk stays alive
        yield s, ids, v


def corpus_device(
    cfg: dict, lens: np.ndarray, seed: int, device: torch.device
) -> Tuple[torch.Tensor, np.ndarray]:
    """Topic-clustered unit token vectors [sum(lens), dim] f32 on `device`,
    and the topics [topics, dim] on the host for the queries.

    Real ColBERT tokens sit ~0.7-0.9 cosine from their nearest centroid;
    unit(topic + s * noise) at s = 0.08, d = 128 gives ~0.74."""
    stream = _stream(cfg, lens, seed, device)
    topics = next(stream)
    toks = torch.empty((int(np.sum(lens)), int(cfg["dim"])), device=device)
    for s, _, v in stream:
        toks[s : s + v.shape[0]] = v
    return toks, topics.cpu().numpy()


def corpus_rows(
    cfg: dict, lens: np.ndarray, seed: int, device: torch.device, rows: np.ndarray
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows at ascending token positions `rows` of the same corpus
    [n, dim], and the unit topic each was drawn around [n, dim]."""
    stream = _stream(cfg, lens, seed, device)
    topics = next(stream)
    want = torch.from_numpy(np.asarray(rows, np.int64)).to(device)
    toks = torch.empty((want.shape[0], int(cfg["dim"])), device=device)
    topic = torch.empty_like(toks)
    for s, ids, v in stream:
        mine = (want >= s) & (want < s + v.shape[0])
        toks[mine] = v[want[mine] - s]
        topic[mine] = topics[ids[want[mine] - s]]
    return toks, topic


def queries(
    cfg: dict, topics: np.ndarray, count: int, seed: int
) -> List[np.ndarray]:
    """`count` distinct queries of `query_tokens` unit tokens, each token a
    random topic plus noise: [query_tokens, dim] f32 arrays."""
    rng = np.random.default_rng(sub_seed(seed, "queries"))
    tokens, dim, noise = int(cfg["query_tokens"]), int(cfg["dim"]), float(cfg["noise"])
    out = []
    for _ in range(count):
        t = topics[rng.integers(0, len(topics), size=tokens)]
        q = (t + noise * rng.standard_normal((tokens, dim))).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        out.append(q)
    return out
