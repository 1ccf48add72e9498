"""FTS5 keyword search over document metadata + hybrid fusion.

Reimplements the behavior of the reference's text_search module
(next-plaid src/text_search.rs): a content-synced FTS5 virtual
table (`METADATA_FTS` backed by `METADATA_FTS_CONTENT`) inside the per-index
`metadata.db`, with

  - three tokenizers: ``unicode61`` (word-level), ``trigram`` (substring), and
    ``identifier_aware`` (unicode61 over text pre-split on camelCase /
    snake_case boundaries, compounds kept — text_search.rs:118-266);
  - O(deleted) incremental deletes via the FTS5 'delete' command and O(N)
    bulk rebuild via ``INSERT INTO fts(fts) VALUES('rebuild')``;
  - BM25 search, optionally restricted to a doc-id subset;
  - rank fusion: RRF (k=60) and relative-score (min-max + alpha)
    (text_search.rs:1006-1075).

Doc ids are the same dense `_subset_` ids as the vector index and the metadata
table; the FTS rowid IS the doc id.
"""

from __future__ import annotations

import sqlite3
from typing import Any, Dict, List, Optional, Sequence, Tuple

from nextplaid_tpu_torch.filtering.metadata import (
    CONTENT_ID_COLUMN,
    CONTENT_TABLE,
    SQLITE_PARAM_LIMIT,
    SUBSET_COLUMN,
    _is_split,
    _table_columns,
    db_path,
    open_write,
)
from nextplaid_tpu_torch.utils.errors import FilteringError

FTS_TABLE = "METADATA_FTS"
FTS_CONTENT_TABLE = "METADATA_FTS_CONTENT"
FTS_CONTENT_COLUMN = "_fts_content_"
FTS_CONFIG_TABLE = "_FTS_SETTINGS_"
RRF_K = 60.0

TOKENIZERS = ("unicode61", "trigram", "identifier_aware")


def _fts5_tokenize_value(tokenizer: str) -> str:
    # identifier_aware rides on unicode61; the splitting happens in
    # _prepare_document_text (text_search.rs:79-86).
    return "trigram" if tokenizer == "trigram" else "unicode61"


def _check_tokenizer(tokenizer: str) -> str:
    if tokenizer not in TOKENIZERS:
        raise FilteringError(
            f"Unknown FTS tokenizer '{tokenizer}'; expected one of {TOKENIZERS}"
        )
    return tokenizer


# ---------------------------------------------------------------------------
# Identifier-aware tokenization (text_search.rs:118-266)
# ---------------------------------------------------------------------------


def _camel_split(token: str) -> List[str]:
    """Split camelCase/PascalCase into lowercase parts; digit runs kept;
    acronyms handled (``getHTTPResponse`` -> get, http, response)."""
    parts: List[str] = []
    i, n = 0, len(token)
    while i < n:
        c = token[i]
        if c.isdigit():
            j = i
            while j < n and token[j].isdigit():
                j += 1
            parts.append(token[i:j])
            i = j
            continue
        if not c.isalpha() or not c.isascii():
            i += 1
            continue
        if c.isupper():
            start = i
            while i + 1 < n and token[i + 1].isupper() and token[i + 1].isascii():
                i += 1
            # Last uppercase before a lowercase belongs to the next word.
            if (
                i + 1 < n
                and token[i].isupper()
                and token[i + 1].islower()
                and i > start
            ):
                parts.append(token[start:i].lower())
                continue
            i += 1
            while i < n and token[i].islower() and token[i].isascii():
                i += 1
            parts.append(token[start:i].lower())
            continue
        start = i
        while i < n and token[i].islower() and token[i].isascii():
            i += 1
        parts.append(token[start:i].lower())
    return parts


def _split_identifier(token: str) -> List[str]:
    """Lowered compound + sub-parts + adjacent-pair snake bigrams."""
    lower = token.lower()
    if "_" in token:
        parts = [p for p in lower.split("_") if p]
    else:
        parts = _camel_split(token)
    if len(parts) < 2:
        return [lower]
    out = [lower, *parts]
    out.extend(f"{a}_{b}" for a, b in zip(parts, parts[1:]))
    return out


def tokenize_identifiers(text: str) -> List[str]:
    """Lowercase identifier-like tokens; compounds expanded AND preserved."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if (c.isalpha() and c.isascii()) or c == "_":
            start = i
            i += 1
            while i < n and ((text[i].isalnum() and text[i].isascii()) or text[i] == "_"):
                i += 1
            out.extend(_split_identifier(text[start:i]))
            continue
        i += 1
    return out


def _prepare_document_text(text: str, tokenizer: str) -> str:
    if tokenizer == "identifier_aware":
        return " ".join(tokenize_identifiers(text))
    return text


# ---------------------------------------------------------------------------
# Metadata -> text (text_search.rs:269-306)
# ---------------------------------------------------------------------------


def metadata_to_text(value: Any) -> str:
    """Flatten a metadata object into one space-joined text blob."""
    parts: List[str] = []

    def walk(v: Any) -> None:
        if isinstance(v, str):
            if v:
                parts.append(v)
        elif isinstance(v, bool):
            parts.append("true" if v else "false")
        elif isinstance(v, (int, float)):
            parts.append(repr(v) if isinstance(v, float) else str(v))
        elif isinstance(v, dict):
            for item in v.values():
                walk(item)
        elif isinstance(v, (list, tuple)):
            for item in v:
                walk(item)

    walk(value)
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Table management
# ---------------------------------------------------------------------------


def _stored_tokenizer(conn: sqlite3.Connection) -> Optional[str]:
    try:
        row = conn.execute(
            f'SELECT value FROM "{FTS_CONFIG_TABLE}" WHERE key = \'tokenizer\''
        ).fetchone()
        return row[0] if row else None
    except sqlite3.Error:
        return None


def _ensure_tables(conn: sqlite3.Connection, tokenizer: str) -> None:
    conn.execute(
        f'CREATE TABLE IF NOT EXISTS "{FTS_CONFIG_TABLE}" '
        "(key TEXT PRIMARY KEY, value TEXT NOT NULL)"
    )
    stored = _stored_tokenizer(conn)
    if stored is not None and stored != tokenizer:
        conn.execute(f'DROP TABLE IF EXISTS "{FTS_TABLE}"')
        conn.execute(f'DROP TABLE IF EXISTS "{FTS_CONTENT_TABLE}"')
    conn.execute(
        f'CREATE TABLE IF NOT EXISTS "{FTS_CONTENT_TABLE}" '
        f'(rowid INTEGER PRIMARY KEY, "{FTS_CONTENT_COLUMN}" TEXT NOT NULL DEFAULT \'\')'
    )
    conn.execute(
        f'CREATE VIRTUAL TABLE IF NOT EXISTS "{FTS_TABLE}" USING fts5('
        f'"{FTS_CONTENT_COLUMN}", content=\'{FTS_CONTENT_TABLE}\', '
        f"content_rowid='rowid', tokenize='{_fts5_tokenize_value(tokenizer)}')"
    )
    conn.execute(
        f'INSERT OR REPLACE INTO "{FTS_CONFIG_TABLE}"(key, value) '
        "VALUES ('tokenizer', ?)",
        (tokenizer,),
    )


def _has_fts(conn: sqlite3.Connection) -> bool:
    row = conn.execute(
        "SELECT COUNT(*) FROM sqlite_master WHERE type='table' AND name=?",
        (FTS_CONTENT_TABLE,),
    ).fetchone()
    return bool(row and row[0])


def exists(index_path) -> bool:
    path = db_path(index_path)
    if not path.exists():
        return False
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        return _has_fts(conn)
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Indexing / delete / update / rebuild
# ---------------------------------------------------------------------------


def index(
    index_path,
    metadata: Sequence[Dict[str, Any]],
    doc_ids: Sequence[int],
    tokenizer: str = "unicode61",
) -> None:
    """Insert one FTS row per document (incremental; text_search.rs:463-501).

    The raw flattened text is stored in the content table; the FTS5 row gets
    the tokenizer-prepared form.
    """
    if not metadata:
        return
    if len(metadata) != len(doc_ids):
        raise FilteringError(
            f"metadata length ({len(metadata)}) must match doc_ids length "
            f"({len(doc_ids)})"
        )
    _check_tokenizer(tokenizer)
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError("No metadata database found. Create metadata first.")
    conn = open_write(path)
    try:
        _ensure_tables(conn, tokenizer)
        conn.execute("BEGIN")
        for row, doc_id in zip(metadata, doc_ids):
            text = metadata_to_text(row)
            conn.execute(
                f'INSERT OR REPLACE INTO "{FTS_CONTENT_TABLE}"'
                f'(rowid, "{FTS_CONTENT_COLUMN}") VALUES (?, ?)',
                (int(doc_id), text),
            )
            conn.execute(
                f'INSERT INTO "{FTS_TABLE}"(rowid, "{FTS_CONTENT_COLUMN}") '
                "VALUES (?, ?)",
                (int(doc_id), _prepare_document_text(text, tokenizer)),
            )
        conn.execute("COMMIT")
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


def delete(index_path, doc_ids: Sequence[int]) -> None:
    """O(deleted) removal via the FTS5 'delete' command (text_search.rs:503-577).

    Note: rowids are NOT re-sequenced here; callers that re-sequence doc ids
    must call `rebuild` (or delete only a suffix, where ids don't shift).
    """
    if not doc_ids:
        return
    path = db_path(index_path)
    if not path.exists():
        return
    conn = open_write(path)
    try:
        if not _has_fts(conn):
            return
        tokenizer = _stored_tokenizer(conn) or "unicode61"
        conn.execute("BEGIN")
        for doc_id in doc_ids:
            row = conn.execute(
                f'SELECT "{FTS_CONTENT_COLUMN}" FROM "{FTS_CONTENT_TABLE}" '
                "WHERE rowid = ?",
                (int(doc_id),),
            ).fetchone()
            if row is None:
                continue
            conn.execute(
                f'INSERT INTO "{FTS_TABLE}"("{FTS_TABLE}", rowid, '
                f'"{FTS_CONTENT_COLUMN}") VALUES(\'delete\', ?, ?)',
                (int(doc_id), _prepare_document_text(row[0], tokenizer)),
            )
            conn.execute(
                f'DELETE FROM "{FTS_CONTENT_TABLE}" WHERE rowid = ?',
                (int(doc_id),),
            )
        conn.execute("COMMIT")
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


def _metadata_text_select(conn: sqlite3.Connection) -> Tuple[List[str], str]:
    """(user_columns, per-row SELECT with `_subset_` first) for FTS re-sync."""
    if _is_split(conn):
        thin = [
            c
            for c in _table_columns(conn, "METADATA")
            if c not in (SUBSET_COLUMN, CONTENT_ID_COLUMN)
        ]
        fat = [
            c for c in _table_columns(conn, CONTENT_TABLE) if c != CONTENT_ID_COLUMN
        ]
        sel = ", ".join(
            [f'M."{SUBSET_COLUMN}"']
            + [f'M."{c}"' for c in thin]
            + [f'C."{c}"' for c in fat]
        )
        sql = (
            f"SELECT {sel} FROM METADATA M JOIN {CONTENT_TABLE} C "
            f'ON M."{CONTENT_ID_COLUMN}" = C."{CONTENT_ID_COLUMN}"'
        )
        return thin + fat, sql
    cols = [c for c in _table_columns(conn, "METADATA") if c != SUBSET_COLUMN]
    sel = ", ".join([f'"{SUBSET_COLUMN}"'] + [f'"{c}"' for c in cols])
    return cols, f"SELECT {sel} FROM METADATA"


def _row_values_to_text(values: Sequence[Any]) -> str:
    parts = []
    for v in values:
        if isinstance(v, str):
            if v:
                parts.append(v)
        elif isinstance(v, (int, float)):
            parts.append(str(v))
    return " ".join(parts)


def update_rows(index_path, doc_ids: Sequence[int]) -> None:
    """Re-sync FTS rows after their metadata changed (text_search.rs:579-685)."""
    if not doc_ids:
        return
    path = db_path(index_path)
    if not path.exists():
        return
    conn = open_write(path)
    try:
        if not _has_fts(conn):
            return
        tokenizer = _stored_tokenizer(conn) or "unicode61"
        _, select_sql = _metadata_text_select(conn)
        where = (
            f' WHERE M."{SUBSET_COLUMN}" = ?'
            if " JOIN " in select_sql
            else f' WHERE "{SUBSET_COLUMN}" = ?'
        )
        conn.execute("BEGIN")
        for doc_id in doc_ids:
            doc_id = int(doc_id)
            old = conn.execute(
                f'SELECT "{FTS_CONTENT_COLUMN}" FROM "{FTS_CONTENT_TABLE}" '
                "WHERE rowid = ?",
                (doc_id,),
            ).fetchone()
            if old is not None:
                conn.execute(
                    f'INSERT INTO "{FTS_TABLE}"("{FTS_TABLE}", rowid, '
                    f'"{FTS_CONTENT_COLUMN}") VALUES(\'delete\', ?, ?)',
                    (doc_id, _prepare_document_text(old[0], tokenizer)),
                )
            row = conn.execute(select_sql + where, (doc_id,)).fetchone()
            if row is not None:
                text = _row_values_to_text(row[1:])
                conn.execute(
                    f'INSERT OR REPLACE INTO "{FTS_CONTENT_TABLE}"'
                    f'(rowid, "{FTS_CONTENT_COLUMN}") VALUES (?, ?)',
                    (doc_id, text),
                )
                conn.execute(
                    f'INSERT INTO "{FTS_TABLE}"(rowid, "{FTS_CONTENT_COLUMN}") '
                    "VALUES (?, ?)",
                    (doc_id, _prepare_document_text(text, tokenizer)),
                )
        conn.execute("COMMIT")
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


def rebuild(index_path) -> None:
    """Drop + repopulate the FTS tables from METADATA, preserving the stored
    tokenizer; the inverted index is built with FTS5's bulk 'rebuild' command
    (text_search.rs:839-945). Required after deletes that re-sequence ids."""
    path = db_path(index_path)
    if not path.exists():
        return
    conn = open_write(path)
    try:
        tokenizer = _stored_tokenizer(conn) or "unicode61"
        conn.execute("BEGIN")
        conn.execute(f'DROP TABLE IF EXISTS "{FTS_TABLE}"')
        conn.execute(f'DROP TABLE IF EXISTS "{FTS_CONTENT_TABLE}"')
        _ensure_tables(conn, tokenizer)
        cols, select_sql = _metadata_text_select(conn)
        order = (
            f' ORDER BY M."{SUBSET_COLUMN}"'
            if " JOIN " in select_sql
            else f' ORDER BY "{SUBSET_COLUMN}"'
        )
        # The content table always stores RAW text (so deletes can re-derive
        # the indexed form); identifier_aware FTS rows are inserted
        # individually with the prepared form, other tokenizers use FTS5's
        # bulk 'rebuild' scan of the content table (raw == prepared there).
        identifier_aware = tokenizer == "identifier_aware"
        for row in conn.execute(select_sql + order).fetchall():
            doc_id = int(row[0])
            text = _row_values_to_text(row[1:]) if cols else ""
            conn.execute(
                f'INSERT INTO "{FTS_CONTENT_TABLE}"(rowid, '
                f'"{FTS_CONTENT_COLUMN}") VALUES (?, ?)',
                (doc_id, text),
            )
            if identifier_aware:
                conn.execute(
                    f'INSERT INTO "{FTS_TABLE}"(rowid, "{FTS_CONTENT_COLUMN}") '
                    "VALUES (?, ?)",
                    (doc_id, _prepare_document_text(text, tokenizer)),
                )
        if not identifier_aware:
            conn.execute(
                f'INSERT INTO "{FTS_TABLE}"("{FTS_TABLE}") VALUES(\'rebuild\')'
            )
        conn.execute("COMMIT")
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# Query sanitizers (text_search.rs:949-1004)
# ---------------------------------------------------------------------------

_FTS_OPERATORS = {"AND", "OR", "NOT", "NEAR"}


def sanitize_fts5_query(query: str) -> str:
    """Quote each word (implicit AND), dropping operators and punctuation."""
    out = []
    for word in query.split():
        # strip non-alphanumeric characters from both edges
        start, end = 0, len(word)
        while start < end and not word[start].isalnum():
            start += 1
        while end > start and not word[end - 1].isalnum():
            end -= 1
        trimmed = word[start:end]
        if not trimmed or trimmed.upper() in _FTS_OPERATORS:
            continue
        out.append('"' + trimmed.replace('"', '""') + '"')
    return " ".join(out)


def sanitize_fts5_query_or(query: str) -> str:
    """Identifier-expanded terms joined with OR (for identifier_aware)."""
    seen = set()
    out = []
    for tok in tokenize_identifiers(query):
        if not tok or tok in seen:
            continue
        seen.add(tok)
        out.append('"' + tok.replace('"', '""') + '"')
    return " OR ".join(out)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def search(index_path, query: str, top_k: int) -> Tuple[List[int], List[float]]:
    """BM25 keyword search; returns (doc_ids, scores) best-first
    (text_search.rs:1246-1275). Scores are negated bm25 (higher = better)."""
    if not query:
        return [], []
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError("No metadata database found.")
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        if not _has_fts(conn):
            raise FilteringError(
                "No FTS index found. Index text first with text_search.index()."
            )
        rows = conn.execute(
            f'SELECT rowid, CAST(-bm25("{FTS_TABLE}") AS REAL) AS score '
            f'FROM "{FTS_TABLE}" WHERE "{FTS_TABLE}" MATCH ? '
            "ORDER BY score DESC LIMIT ?",
            (query, int(top_k)),
        ).fetchall()
    except sqlite3.OperationalError as e:
        raise FilteringError(f"FTS5 query failed: {e}") from e
    finally:
        conn.close()
    return [int(r[0]) for r in rows], [float(r[1]) for r in rows]


def search_filtered(
    index_path, query: str, top_k: int, subset: Sequence[int]
) -> Tuple[List[int], List[float]]:
    """BM25 search restricted to a doc-id subset (text_search.rs:1277-1358)."""
    if not subset or not query:
        return [], []
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError("No metadata database found.")
    ids = [int(i) for i in subset]
    merged: List[Tuple[int, float]] = []
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        if not _has_fts(conn):
            raise FilteringError(
                "No FTS index found. Index text first with text_search.index()."
            )
        for i in range(0, len(ids), SQLITE_PARAM_LIMIT):
            chunk = ids[i : i + SQLITE_PARAM_LIMIT]
            qs = ", ".join(["?"] * len(chunk))
            rows = conn.execute(
                f'SELECT rowid, CAST(-bm25("{FTS_TABLE}") AS REAL) AS score '
                f'FROM "{FTS_TABLE}" WHERE "{FTS_TABLE}" MATCH ? '
                f"AND rowid IN ({qs}) ORDER BY score DESC LIMIT ?",
                [query, *chunk, int(top_k)],
            ).fetchall()
            merged.extend((int(r[0]), float(r[1])) for r in rows)
    except sqlite3.OperationalError as e:
        raise FilteringError(f"FTS5 query failed: {e}") from e
    finally:
        conn.close()
    merged.sort(key=lambda t: -t[1])
    merged = merged[: int(top_k)]
    return [i for i, _ in merged], [s for _, s in merged]


# ---------------------------------------------------------------------------
# Fusion (text_search.rs:1006-1075)
# ---------------------------------------------------------------------------


def fuse_rrf(
    sem_ids: Sequence[int],
    kw_ids: Sequence[int],
    alpha: float,
    top_k: int,
) -> Tuple[List[int], List[float]]:
    """Reciprocal Rank Fusion; alpha=1 pure semantic, 0 pure keyword."""
    scores: Dict[int, float] = {}
    for rank, doc_id in enumerate(sem_ids):
        scores[int(doc_id)] = scores.get(int(doc_id), 0.0) + alpha / (
            RRF_K + rank + 1.0
        )
    for rank, doc_id in enumerate(kw_ids):
        scores[int(doc_id)] = scores.get(int(doc_id), 0.0) + (1.0 - alpha) / (
            RRF_K + rank + 1.0
        )
    combined = sorted(scores.items(), key=lambda t: -t[1])[: int(top_k)]
    return [i for i, _ in combined], [s for _, s in combined]


def fuse_relative_score(
    sem_ids: Sequence[int],
    sem_scores: Sequence[float],
    kw_ids: Sequence[int],
    kw_scores: Sequence[float],
    alpha: float,
    top_k: int,
) -> Tuple[List[int], List[float]]:
    """Min-max normalize both lists to [0,1], combine with alpha weighting."""

    def norm(ids, ss) -> List[Tuple[int, float]]:
        if not len(ss):
            return []
        lo, hi = min(ss), max(ss)
        if hi == lo:
            return [(int(i), 1.0) for i in ids]
        return [(int(i), (s - lo) / (hi - lo)) for i, s in zip(ids, ss)]

    scores: Dict[int, float] = {}
    for doc_id, s in norm(sem_ids, sem_scores):
        scores[doc_id] = scores.get(doc_id, 0.0) + alpha * s
    for doc_id, s in norm(kw_ids, kw_scores):
        scores[doc_id] = scores.get(doc_id, 0.0) + (1.0 - alpha) * s
    combined = sorted(scores.items(), key=lambda t: -t[1])[: int(top_k)]
    return [i for i, _ in combined], [s for _, s in combined]
