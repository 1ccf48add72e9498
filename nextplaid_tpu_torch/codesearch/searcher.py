"""Hybrid code searcher.

Rebuild of the reference's hybrid pipeline
(colgrep/src/index/mod.rs:3611-4300,
search_hybrid_with_embedding at 4093-4290):

  fetch_k = max(20 * top_k, 200)
  -> semantic PLAID search + FTS5 BM25 (identifier-aware OR query)
  -> relative-score fusion
  -> file-path noise penalty (multiplicative; skipped for test-seeking
     queries)
  -> path-stem boost -> definition-name boost -> file-coherence boost
  -> collapse to one result per file -> top_k

Filters: path prefix, glob include/exclude, and `-e` regex over code via
the REGEXP UDF on the metadata store.

The index is loaded and searched on `device` ("cuda" when None). A code
index sits far below `SearchParameters.exact_max_embeddings`, so the
semantic leg is the exhaustive scan of the unpinned index, as in the JAX
package.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from nextplaid_tpu_torch import filtering
from nextplaid_tpu_torch.codesearch import ranking
from nextplaid_tpu_torch.codesearch.types import DEFINITION_TYPES
from nextplaid_tpu_torch.filtering import text_search
from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters, search_batch
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class SearchHit:
    doc_id: int
    score: float
    file: str
    name: str
    unit_type: str
    line: int
    end_line: int
    language: str
    signature: str = ""
    code: str = ""
    docstring: str = ""


@dataclass
class SearchOptions:
    top_k: int = 10
    path_prefix: Optional[str] = None
    include_globs: List[str] = field(default_factory=list)
    exclude_globs: List[str] = field(default_factory=list)
    exclude_dirs: List[str] = field(default_factory=list)
    regex: Optional[str] = None  # -e: filter candidates by code regex
    case_sensitive: bool = False
    no_rank_boosts: bool = False


class Searcher:
    def __init__(self, index_dir: str, encoder, device: DeviceLike = None):
        self.index_dir = str(index_dir)
        self.encoder = encoder
        self.device = resolve_device(device)
        self._index: Optional[DeviceIndex] = None

    @property
    def index(self) -> DeviceIndex:
        if self._index is None:
            self._index = DeviceIndex.load(self.index_dir, device=self.device)
        return self._index

    def reload(self) -> None:
        self._index = None

    # -- filters ---------------------------------------------------------------

    def _subset_for(self, opts: SearchOptions) -> Optional[List[int]]:
        """Build the candidate doc-id subset from path/regex filters
        (reference index/mod.rs:3611-3700, regex at 3142/4016)."""
        conds: List[str] = []
        params: List = []
        if opts.path_prefix:
            conds.append("file LIKE ?")
            params.append(opts.path_prefix.rstrip("/") + "%")
        if opts.regex:
            pattern = opts.regex
            if not opts.case_sensitive:
                pattern = "(?i)" + pattern
            # The REGEXP pattern must be the first parameter (it is compiled
            # once per query by the UDF, filtering.rs:1969).
            ids = filtering.where_condition_regexp(
                self.index_dir, "code REGEXP ?", [pattern]
            )
            if opts.path_prefix:
                rows = filtering.get(self.index_dir, subset=ids)
                prefix = opts.path_prefix.rstrip("/")
                ids = [
                    int(r["_subset_"])
                    for r in rows
                    if str(r.get("file", "")).startswith(prefix)
                ]
            return self._apply_globs(ids, opts)
        if conds:
            ids = filtering.where_condition(
                self.index_dir, " AND ".join(conds), params
            )
            return self._apply_globs(ids, opts)
        if opts.include_globs or opts.exclude_globs or opts.exclude_dirs:
            rows = filtering.get(self.index_dir)
            ids = [int(r["_subset_"]) for r in rows]
            return self._apply_globs(ids, opts, rows=rows)
        return None

    def _apply_globs(
        self, ids: List[int], opts: SearchOptions, rows=None
    ) -> List[int]:
        if not (opts.include_globs or opts.exclude_globs or opts.exclude_dirs):
            return ids
        if rows is None:
            rows = filtering.get(self.index_dir, subset=ids)
        out = []
        for r in rows:
            f = str(r.get("file", ""))
            base = f.rsplit("/", 1)[-1]
            if opts.include_globs and not any(
                fnmatch.fnmatch(base, g) or fnmatch.fnmatch(f, g)
                for g in opts.include_globs
            ):
                continue
            if opts.exclude_globs and any(
                fnmatch.fnmatch(base, g) or fnmatch.fnmatch(f, g)
                for g in opts.exclude_globs
            ):
                continue
            if opts.exclude_dirs and any(
                f"/{d}/" in f"/{f}" or f.startswith(d.rstrip("/") + "/")
                for d in opts.exclude_dirs
            ):
                continue
            out.append(int(r["_subset_"]))
        return out

    # -- search ----------------------------------------------------------------

    def search(
        self,
        query: str,
        opts: Optional[SearchOptions] = None,
        stages: Optional[Dict[str, float]] = None,
    ) -> List[SearchHit]:
        """The hits of `query`. `stages`, when a dict, receives the host
        seconds of each leg: "filters", "encode_queries", "search_batch"
        (it returns host lists, so it has waited for the device), "keyword"
        and "fuse_rank" (fusion, the metadata rows and the ranking)."""
        opts = opts or SearchOptions()
        clock = _Clock(stages)
        subset = self._subset_for(opts)
        clock.lap("filters")
        if subset is not None and not subset:
            return []
        fetch_k = max(20 * opts.top_k, 200)

        # Semantic leg.
        q_emb = self.encoder.encode_queries([query])[0]
        clock.lap("encode_queries")
        sem = search_batch(
            self.index,
            [q_emb],
            SearchParameters(top_k=fetch_k),
            subset=subset,
        )[0]
        clock.lap("search_batch")

        # Keyword leg (identifier-aware OR query).
        kw_query = text_search.sanitize_fts5_query_or(query)
        if subset is not None:
            kw_ids, kw_scores = text_search.search_filtered(
                self.index_dir, kw_query, fetch_k, subset
            )
        else:
            kw_ids, kw_scores = text_search.search(
                self.index_dir, kw_query, fetch_k
            )
        clock.lap("keyword")

        fused_ids, fused_scores = text_search.fuse_relative_score(
            sem.passage_ids, sem.scores, kw_ids, kw_scores,
            alpha=0.75, top_k=fetch_k,
        )
        if not fused_ids:
            return []

        rows = filtering.get(self.index_dir, subset=fused_ids)
        by_id: Dict[int, dict] = {int(r["_subset_"]): r for r in rows}
        hits: List[SearchHit] = []
        for doc_id, score in zip(fused_ids, fused_scores):
            row = by_id.get(int(doc_id))
            if row is None:
                continue
            hits.append(
                SearchHit(
                    doc_id=int(doc_id),
                    score=float(score),
                    file=str(row.get("file", "")),
                    name=str(row.get("name", "")),
                    unit_type=str(row.get("unit_type", "")),
                    line=int(row.get("line") or 0),
                    end_line=int(row.get("end_line") or 0),
                    language=str(row.get("language", "")),
                    signature=str(row.get("signature") or ""),
                    code=str(row.get("code") or ""),
                    docstring=str(row.get("docstring") or ""),
                )
            )

        if not opts.no_rank_boosts:
            if ranking.should_apply_path_penalty(query):
                for h in hits:
                    h.score *= ranking.file_path_penalty(h.file)
            get_score = lambda h: h.score  # noqa: E731
            set_score = lambda h, s: setattr(h, "score", s)  # noqa: E731
            ranking.apply_path_stem_boost(
                hits, query, lambda h: h.file, get_score, set_score
            )
            ranking.apply_definition_boost(
                hits, query,
                lambda h: h.name,
                lambda h: h.unit_type in DEFINITION_TYPES,
                get_score, set_score,
            )
            ranking.apply_file_coherence_boost(
                hits, lambda h: h.file, get_score, set_score
            )

        # Collapse to one (best) hit per file, then top_k
        # (reference index/mod.rs:4270-4290).
        hits.sort(key=lambda h: -h.score)
        seen_files = set()
        out: List[SearchHit] = []
        for h in hits:
            if h.file in seen_files:
                continue
            seen_files.add(h.file)
            out.append(h)
            if len(out) >= opts.top_k:
                break
        clock.lap("fuse_rank")
        return out


class _Clock:
    """Host seconds between laps, written into `stages` when it is a dict."""

    def __init__(self, stages: Optional[Dict[str, float]]):
        self.stages = stages
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.stages is not None:
            now = time.perf_counter()
            self.stages[name] = now - self.t
            self.t = now
