"""SQLite-backed per-index document metadata with safe filtered queries.

Host-side subsystem of the engine: search runs on the device, but the boolean
subset masks it consumes come from this store. Reimplements the behavior of the
reference's filtering module (next-plaid src/filtering.rs):

  - `metadata.db` inside the index directory; document id column `_subset_`
    kept dense 0..N-1 (aligned with the vector index's doc ids);
  - v2 thin/fat split schema: `METADATA` holds small filterable columns plus a
    `_content_id_` FK; `METADATA_CONTENT` holds large TEXT columns that never
    move, so delete re-sequencing only rewrites small integers
    (filtering.rs:66-91, 879-911);
  - older v0 (rowid-PK) and v1 (demoted indexed column) layouts remain
    readable, with lazy migration v0→v1 on the first delete
    (filtering.rs:792-877);
  - injection safety via the allowlist condition validator (conditions.py) and
    identifier-shaped column names only;
  - `REGEXP` conditions served by a Python `re` UDF with the pattern compiled
    once per query (filtering.rs:1969-2076).
"""

from __future__ import annotations

import base64
import json
import re
import sqlite3
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from nextplaid_tpu_torch.filtering.conditions import (
    is_valid_column_name,
    validate_condition,
)
from nextplaid_tpu_torch.utils.errors import FilteringError

METADATA_DB_NAME = "metadata.db"
SUBSET_COLUMN = "_subset_"
CONTENT_TABLE = "METADATA_CONTENT"
CONTENT_ID_COLUMN = "_content_id_"
SUBSET_INDEX_NAME = "idx_metadata_subset"
SCHEMA_V1 = 1
SCHEMA_V2 = 2
SQLITE_PARAM_LIMIT = 900

# Columns that live in the thin METADATA table under the v2 split layout; all
# other user columns go to METADATA_CONTENT (filtering.rs:79-91).
THIN_COLUMNS = frozenset(
    {
        "file",
        "name",
        "qualified_name",
        "line",
        "end_line",
        "language",
        "unit_type",
        "complexity",
        "has_loops",
        "has_branches",
        "has_error_handling",
    }
)


def db_path(index_path) -> Path:
    return Path(index_path) / METADATA_DB_NAME


def exists(index_path) -> bool:
    return db_path(index_path).exists()


# ---------------------------------------------------------------------------
# Connections
# ---------------------------------------------------------------------------

_READ_CONNS: Dict[str, sqlite3.Connection] = {}
_READ_LOCKS: Dict[str, threading.Lock] = {}
_READ_GUARD = threading.Lock()


def _open_read(path: Path) -> sqlite3.Connection:
    conn = sqlite3.connect(
        f"file:{path}?mode=ro", uri=True, check_same_thread=False
    )
    conn.execute("PRAGMA busy_timeout=5000")
    conn.execute("PRAGMA temp_store=MEMORY")
    conn.execute("PRAGMA query_only=ON")
    return conn


class _ReadConn:
    """Context manager yielding a cached read connection under its lock."""

    def __init__(self, path: Path):
        self.key = str(path)
        self.path = path

    def __enter__(self) -> sqlite3.Connection:
        with _READ_GUARD:
            lock = _READ_LOCKS.setdefault(self.key, threading.Lock())
        lock.acquire()
        self._lock = lock
        try:
            with _READ_GUARD:
                conn = _READ_CONNS.get(self.key)
            if conn is None:
                conn = _open_read(self.path)
                with _READ_GUARD:
                    _READ_CONNS.setdefault(self.key, conn)
                    conn = _READ_CONNS[self.key]
            return conn
        except BaseException:
            lock.release()
            raise

    def __exit__(self, *exc) -> None:
        self._lock.release()


def invalidate_read_connection(index_path) -> None:
    key = str(db_path(index_path))
    with _READ_GUARD:
        conn = _READ_CONNS.pop(key, None)
    if conn is not None:
        try:
            conn.close()
        except sqlite3.Error:
            pass


def open_write(path: Path) -> sqlite3.Connection:
    conn = sqlite3.connect(str(path), check_same_thread=False)
    conn.execute("PRAGMA busy_timeout=5000")
    conn.execute("PRAGMA journal_mode=WAL")
    conn.execute("PRAGMA synchronous=NORMAL")
    conn.execute("PRAGMA temp_store=MEMORY")
    conn.isolation_level = None  # explicit transactions
    return conn


# ---------------------------------------------------------------------------
# Value / type mapping
# ---------------------------------------------------------------------------


def _infer_sql_type(value: Any) -> str:
    if isinstance(value, bool):
        return "INTEGER"
    if isinstance(value, int):
        return "INTEGER"
    if isinstance(value, float):
        return "REAL"
    if isinstance(value, str) or value is None:
        return "TEXT"
    return "BLOB"  # arrays / objects, stored as JSON text


def _to_sql(value: Any) -> Any:
    if value is None or isinstance(value, (int, float, str)):
        return int(value) if isinstance(value, bool) else value
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, bytes):
        return value
    return json.dumps(value)


def _from_sql(value: Any) -> Any:
    if isinstance(value, bytes):
        return base64.b64encode(value).decode("ascii")
    return value


# ---------------------------------------------------------------------------
# Schema helpers
# ---------------------------------------------------------------------------


def _schema_version(conn: sqlite3.Connection) -> int:
    try:
        return int(conn.execute("PRAGMA user_version").fetchone()[0])
    except sqlite3.Error:
        return 0


def _is_split(conn: sqlite3.Connection) -> bool:
    return _schema_version(conn) >= SCHEMA_V2


def _table_columns(conn: sqlite3.Connection, table: str) -> List[str]:
    return [r[1] for r in conn.execute(f'PRAGMA table_info("{table}")')]


def _is_thin_column(col: str) -> bool:
    return col in (SUBSET_COLUMN, CONTENT_ID_COLUMN) or col in THIN_COLUMNS


def schema_columns(conn: sqlite3.Connection) -> Set[str]:
    """User-visible columns across both tables (excludes `_content_id_` on v2)."""
    split = _is_split(conn)
    cols = {
        c
        for c in _table_columns(conn, "METADATA")
        if not (split and c == CONTENT_ID_COLUMN)
    }
    if split:
        cols.update(
            c for c in _table_columns(conn, CONTENT_TABLE) if c != CONTENT_ID_COLUMN
        )
    return cols


def _validate_column_names(names: Iterable[str]) -> None:
    for name in names:
        if not is_valid_column_name(name):
            raise FilteringError(
                f"Invalid column name '{name}'. Column names must start with a "
                "letter or underscore, followed by letters, digits, or underscores."
            )


def _create_subset_index(conn: sqlite3.Connection) -> None:
    conn.execute(
        f'CREATE INDEX IF NOT EXISTS "{SUBSET_INDEX_NAME}" '
        f'ON METADATA ("{SUBSET_COLUMN}")'
    )


def _infer_columns(metadata: Sequence[Dict[str, Any]]) -> List[Tuple[str, str]]:
    """Ordered (name, sql_type) union over all rows; type from first non-null."""
    order: List[str] = []
    types: Dict[str, str] = {}
    for row in metadata:
        if not isinstance(row, dict):
            raise FilteringError("Expected metadata rows to be JSON objects")
        for key, value in row.items():
            if key not in types:
                order.append(key)
                types[key] = _infer_sql_type(value) if value is not None else "TEXT"
            elif types[key] == "TEXT" and value is not None:
                pass  # first-seen type wins, as in the reference
    _validate_column_names(order)
    return [(name, types[name]) for name in order]


def _create_tables_v2(
    conn: sqlite3.Connection, columns: Sequence[Tuple[str, str]]
) -> None:
    thin = [
        f'"{SUBSET_COLUMN}" INTEGER NOT NULL',
        f'"{CONTENT_ID_COLUMN}" INTEGER NOT NULL',
    ]
    fat = [f'"{CONTENT_ID_COLUMN}" INTEGER PRIMARY KEY']
    for name, sql_type in columns:
        (thin if _is_thin_column(name) else fat).append(f'"{name}" {sql_type}')
    conn.execute(f"CREATE TABLE METADATA ({', '.join(thin)})")
    conn.execute(f"CREATE TABLE {CONTENT_TABLE} ({', '.join(fat)})")
    _create_subset_index(conn)
    conn.execute(f"PRAGMA user_version={SCHEMA_V2}")


def _insert_rows_v2(
    conn: sqlite3.Connection,
    metadata: Sequence[Dict[str, Any]],
    doc_ids: Sequence[int],
) -> int:
    thin_cols = [
        c
        for c in _table_columns(conn, "METADATA")
        if c not in (SUBSET_COLUMN, CONTENT_ID_COLUMN)
    ]
    fat_cols = [
        c for c in _table_columns(conn, CONTENT_TABLE) if c != CONTENT_ID_COLUMN
    ]
    next_cid = int(
        conn.execute(
            f'SELECT COALESCE(MAX("{CONTENT_ID_COLUMN}"), -1) + 1 '
            f"FROM {CONTENT_TABLE}"
        ).fetchone()[0]
    )
    fat_sql = (
        f'INSERT INTO {CONTENT_TABLE} ("{CONTENT_ID_COLUMN}"'
        + "".join(f', "{c}"' for c in fat_cols)
        + ") VALUES ("
        + ", ".join(["?"] * (len(fat_cols) + 1))
        + ")"
    )
    thin_sql = (
        f'INSERT INTO METADATA ("{SUBSET_COLUMN}", "{CONTENT_ID_COLUMN}"'
        + "".join(f', "{c}"' for c in thin_cols)
        + ") VALUES ("
        + ", ".join(["?"] * (len(thin_cols) + 2))
        + ")"
    )
    for i, row in enumerate(metadata):
        if not isinstance(row, dict):
            row = {}
        cid = next_cid + i
        conn.execute(fat_sql, [cid] + [_to_sql(row.get(c)) for c in fat_cols])
        conn.execute(
            thin_sql,
            [int(doc_ids[i]), cid] + [_to_sql(row.get(c)) for c in thin_cols],
        )
    return len(metadata)


def _insert_rows_flat(
    conn: sqlite3.Connection,
    metadata: Sequence[Dict[str, Any]],
    doc_ids: Sequence[int],
) -> int:
    cols = [c for c in _table_columns(conn, "METADATA") if c != SUBSET_COLUMN]
    sql = (
        f'INSERT INTO METADATA ("{SUBSET_COLUMN}"'
        + "".join(f', "{c}"' for c in cols)
        + ") VALUES ("
        + ", ".join(["?"] * (len(cols) + 1))
        + ")"
    )
    for i, row in enumerate(metadata):
        if not isinstance(row, dict):
            row = {}
        conn.execute(sql, [int(doc_ids[i])] + [_to_sql(row.get(c)) for c in cols])
    return len(metadata)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def create(
    index_path, metadata: Sequence[Dict[str, Any]], doc_ids: Sequence[int]
) -> int:
    """Create `metadata.db` (v2 layout), replacing any existing one
    (filtering.rs:1141-1330)."""
    if len(metadata) != len(doc_ids):
        raise FilteringError(
            f"Metadata length ({len(metadata)}) must match doc_ids length "
            f"({len(doc_ids)})"
        )
    root = Path(index_path)
    root.mkdir(parents=True, exist_ok=True)
    path = db_path(index_path)
    if path.exists():
        invalidate_read_connection(index_path)
        path.unlink()
        for suffix in ("-wal", "-shm"):
            Path(str(path) + suffix).unlink(missing_ok=True)
    if not metadata:
        return 0
    columns = _infer_columns(metadata)
    conn = open_write(path)
    try:
        conn.execute("BEGIN")
        _create_tables_v2(conn, columns)
        n = _insert_rows_v2(conn, metadata, doc_ids)
        conn.execute("COMMIT")
        return n
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


def update(
    index_path, metadata: Sequence[Dict[str, Any]], doc_ids: Sequence[int]
) -> int:
    """Append rows, ALTERing in any new columns first (filtering.rs:1332-1644)."""
    if not metadata:
        return 0
    if len(metadata) != len(doc_ids):
        raise FilteringError(
            f"Metadata length ({len(metadata)}) must match doc_ids length "
            f"({len(doc_ids)})"
        )
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError(
            "Metadata database does not exist. Use create() first."
        )
    new_columns = _infer_columns(metadata)
    conn = open_write(path)
    try:
        split = _is_split(conn)
        existing = schema_columns(conn)
        missing = [(n, t) for (n, t) in new_columns if n not in existing]
        conn.execute("BEGIN")
        for name, sql_type in missing:
            if split:
                table = "METADATA" if _is_thin_column(name) else CONTENT_TABLE
            else:
                table = "METADATA"
            conn.execute(f'ALTER TABLE "{table}" ADD COLUMN "{name}" {sql_type}')
        if split:
            n = _insert_rows_v2(conn, metadata, doc_ids)
        else:
            n = _insert_rows_flat(conn, metadata, doc_ids)
        conn.execute("COMMIT")
        invalidate_read_connection(index_path)
        return n
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


def _migrate_v0_to_v1(conn: sqlite3.Connection) -> None:
    """Demote a rowid-PK `_subset_` to a plain indexed column
    (filtering.rs:792-877). One-time table copy, stamped via user_version."""
    if _schema_version(conn) >= SCHEMA_V1:
        return
    has_table = conn.execute(
        "SELECT COUNT(*) FROM sqlite_master WHERE type='table' AND name='METADATA'"
    ).fetchone()[0]
    if not has_table:
        return
    info = list(conn.execute("PRAGMA table_info(METADATA)"))
    subset_is_pk = any(r[1] == SUBSET_COLUMN and r[5] > 0 for r in info)
    if not subset_is_pk:
        _create_subset_index(conn)
        conn.execute(f"PRAGMA user_version={SCHEMA_V1}")
        return
    col_defs = []
    for r in info:
        name, declared = r[1], (r[2] or "TEXT")
        if name == SUBSET_COLUMN:
            col_defs.append(f'"{SUBSET_COLUMN}" INTEGER NOT NULL')
        else:
            col_defs.append(f'"{name}" {declared}')
    names = ", ".join(f'"{r[1]}"' for r in info)
    conn.execute("ALTER TABLE METADATA RENAME TO _METADATA_V0")
    conn.execute(f"CREATE TABLE METADATA ({', '.join(col_defs)})")
    conn.execute(f"INSERT INTO METADATA ({names}) SELECT {names} FROM _METADATA_V0")
    _create_subset_index(conn)
    conn.execute("DROP TABLE _METADATA_V0")
    conn.execute(f"PRAGMA user_version={SCHEMA_V1}")


def _resequence(conn: sqlite3.Connection, deleted_ids: List[int], original_count: int) -> None:
    """Shift surviving `_subset_` ids down so they stay dense 0..N-1.

    Consecutive deleted ids form one gap; every survivor between two gaps gets
    the same downward shift (number of deletions to its left). Processing gaps
    in ascending order means decremented values never collide
    (filtering.rs:1699-1760).
    """
    ids = sorted({i for i in deleted_ids if 0 <= i < original_count})
    if not ids:
        return
    max_id = conn.execute(
        f'SELECT COALESCE(MAX("{SUBSET_COLUMN}"), -1) FROM METADATA'
    ).fetchone()[0]
    if max_id < 0:
        return
    i = 0
    while i < len(ids):
        j = i + 1
        while j < len(ids) and ids[j] == ids[j - 1] + 1:
            j += 1
        range_start = ids[j - 1] + 1
        range_end = ids[j] if j < len(ids) else max_id + len(ids) + 1
        if range_start < range_end:
            conn.execute(
                f'UPDATE METADATA SET "{SUBSET_COLUMN}" = "{SUBSET_COLUMN}" - ? '
                f'WHERE "{SUBSET_COLUMN}" >= ? AND "{SUBSET_COLUMN}" < ?',
                (j, range_start, range_end),
            )
        i = j


def delete(index_path, subset: Sequence[int]) -> int:
    """Delete rows by doc id and re-sequence survivors to dense 0..N-1
    (filtering.rs:1646-1878). Returns the number of rows deleted."""
    if not subset:
        return 0
    path = db_path(index_path)
    if not path.exists():
        return 0
    conn = open_write(path)
    try:
        split = _is_split(conn)
        if not split:
            _migrate_v0_to_v1(conn)
        conn.execute("BEGIN")
        original_count = (
            conn.execute(
                f'SELECT COALESCE(MAX("{SUBSET_COLUMN}"), -1) FROM METADATA'
            ).fetchone()[0]
            + 1
        )
        ids = [int(i) for i in subset]
        deleted = 0
        if split:
            # Remove the fat rows first (via the FK), then the thin rows.
            for chunk in _chunks(ids, SQLITE_PARAM_LIMIT):
                qs = ", ".join(["?"] * len(chunk))
                conn.execute(
                    f"DELETE FROM {CONTENT_TABLE} WHERE \"{CONTENT_ID_COLUMN}\" IN "
                    f'(SELECT "{CONTENT_ID_COLUMN}" FROM METADATA '
                    f'WHERE "{SUBSET_COLUMN}" IN ({qs}))',
                    chunk,
                )
        for chunk in _chunks(ids, SQLITE_PARAM_LIMIT):
            qs = ", ".join(["?"] * len(chunk))
            cur = conn.execute(
                f'DELETE FROM METADATA WHERE "{SUBSET_COLUMN}" IN ({qs})', chunk
            )
            deleted += cur.rowcount
        _resequence(conn, ids, original_count)
        conn.execute("COMMIT")
        invalidate_read_connection(index_path)
        return deleted
    except BaseException:
        conn.execute("ROLLBACK")
        raise
    finally:
        conn.close()


def _chunks(seq: List[int], n: int):
    for i in range(0, len(seq), n):
        yield seq[i : i + n]


def _fat_columns(conn: sqlite3.Connection) -> List[str]:
    try:
        return [
            c for c in _table_columns(conn, CONTENT_TABLE) if c != CONTENT_ID_COLUMN
        ]
    except sqlite3.Error:
        return []


def _condition_references_fat(conn: sqlite3.Connection, condition: str) -> bool:
    upper = condition.upper()
    return any(c.upper() in upper for c in _fat_columns(conn))


def _subset_query(conn: sqlite3.Connection, condition: str) -> str:
    if _is_split(conn) and _condition_references_fat(conn, condition):
        return (
            f'SELECT M."{SUBSET_COLUMN}" FROM METADATA M '
            f'JOIN {CONTENT_TABLE} C ON M."{CONTENT_ID_COLUMN}" = '
            f'C."{CONTENT_ID_COLUMN}" WHERE {condition}'
        )
    return f'SELECT "{SUBSET_COLUMN}" FROM METADATA WHERE {condition}'


def where_condition(
    index_path, condition: str, parameters: Sequence[Any] = ()
) -> List[int]:
    """Doc ids matching a validated WHERE condition (filtering.rs:1880-1924)."""
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError(
            "No metadata database found. Create it first by adding metadata "
            "during index creation."
        )
    with _ReadConn(path) as conn:
        validate_condition(condition, schema_columns(conn))
        query = _subset_query(conn, condition)
        rows = conn.execute(query, [_to_sql(p) for p in parameters]).fetchall()
        return [int(r[0]) for r in rows]


def where_condition_regexp(
    index_path, condition: str, parameters: Sequence[Any] = ()
) -> List[int]:
    """Like `where_condition` but with a REGEXP UDF; the pattern (first
    parameter) is compiled once per query (filtering.rs:1969-2076)."""
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError(
            "No metadata database found. Create it first by adding metadata "
            "during index creation."
        )
    if not parameters or not isinstance(parameters[0], str):
        raise FilteringError("REGEXP requires a pattern parameter")
    try:
        compiled = re.compile(parameters[0])
    except re.error as e:
        raise FilteringError(
            f"Invalid regex pattern '{parameters[0]}': {e}"
        ) from e

    def regexp(_pattern: str, text: Optional[str]) -> bool:
        if text is None:
            return False
        try:
            return compiled.search(text) is not None
        except re.error:
            return False

    # A dedicated connection: UDF registration must not leak into the cache.
    conn = _open_read(path)
    try:
        conn.create_function("regexp", 2, regexp, deterministic=True)
        validate_condition(condition, schema_columns(conn))
        query = _subset_query(conn, condition)
        rows = conn.execute(query, [_to_sql(p) for p in parameters]).fetchall()
        return [int(r[0]) for r in rows]
    finally:
        conn.close()


def get_distinct_strings(index_path, column: str) -> List[str]:
    """Distinct non-NULL strings of one column (filtering.rs:2078-2141)."""
    path = db_path(index_path)
    if not path.exists():
        return []
    if not is_valid_column_name(column):
        raise FilteringError(f"Invalid column name '{column}'")
    with _ReadConn(path) as conn:
        split = _is_split(conn)
        if column in _table_columns(conn, "METADATA"):
            table = "METADATA"
        elif split and column in _table_columns(conn, CONTENT_TABLE):
            table = CONTENT_TABLE
        else:
            return []
        rows = conn.execute(
            f'SELECT DISTINCT "{column}" FROM "{table}" '
            f'WHERE "{column}" IS NOT NULL'
        ).fetchall()
        return [r[0] for r in rows if isinstance(r[0], str)]


def _select_all_query(conn: sqlite3.Connection) -> Tuple[str, List[str]]:
    """SELECT over user-visible columns (JOINed for v2), plus column order."""
    if not _is_split(conn):
        cols = _table_columns(conn, "METADATA")
        return "SELECT * FROM METADATA", cols
    thin = [c for c in _table_columns(conn, "METADATA") if c != CONTENT_ID_COLUMN]
    fat = _fat_columns(conn)
    sel = ", ".join(
        [f'M."{c}"' for c in thin] + [f'C."{c}"' for c in fat]
    )
    query = (
        f"SELECT {sel} FROM METADATA M JOIN {CONTENT_TABLE} C "
        f'ON M."{CONTENT_ID_COLUMN}" = C."{CONTENT_ID_COLUMN}"'
    )
    return query, thin + fat


def get(
    index_path,
    condition: Optional[str] = None,
    parameters: Sequence[Any] = (),
    subset: Optional[Sequence[int]] = None,
) -> List[Dict[str, Any]]:
    """Fetch metadata rows by condition or by doc-id subset
    (filtering.rs:2143-2373). Subset results preserve the requested order."""
    if condition is not None and subset is not None:
        raise FilteringError(
            "Please provide either a 'condition' or a 'subset', not both."
        )
    path = db_path(index_path)
    if not path.exists():
        return []
    with _ReadConn(path) as conn:
        if condition is not None:
            validate_condition(condition, schema_columns(conn))
        base, cols = _select_all_query(conn)

        def rows_to_dicts(rows) -> List[Dict[str, Any]]:
            return [
                {c: _from_sql(v) for c, v in zip(cols, row)} for row in rows
            ]

        if subset is not None:
            ids = [int(i) for i in subset]
            if not ids:
                return []
            by_id: Dict[int, Dict[str, Any]] = {}
            for chunk in _chunks(ids, SQLITE_PARAM_LIMIT):
                qs = ", ".join(["?"] * len(chunk))
                clause = (
                    f' WHERE M."{SUBSET_COLUMN}" IN ({qs})'
                    if " JOIN " in base
                    else f' WHERE "{SUBSET_COLUMN}" IN ({qs})'
                )
                for d in rows_to_dicts(conn.execute(base + clause, chunk)):
                    by_id[int(d[SUBSET_COLUMN])] = d
            return [by_id[i] for i in ids if i in by_id]

        order = (
            f' ORDER BY M."{SUBSET_COLUMN}"'
            if " JOIN " in base
            else f' ORDER BY "{SUBSET_COLUMN}"'
        )
        if condition is not None:
            query = base + f" WHERE ({condition})" + order
            rows = conn.execute(query, [_to_sql(p) for p in parameters])
        else:
            rows = conn.execute(base + order)
        return rows_to_dicts(rows)


def update_where(
    index_path,
    condition: str,
    parameters: Sequence[Any],
    updates: Dict[str, Any],
) -> int:
    """UPDATE matching rows' columns; returns affected row count and triggers
    FTS re-sync for them (filtering.rs:2457-2677)."""
    path = db_path(index_path)
    if not path.exists():
        raise FilteringError(
            "No metadata database found. Create it first by adding metadata "
            "during index creation."
        )
    if not isinstance(updates, dict):
        raise FilteringError("Updates must be a JSON object")
    if not updates:
        return 0
    conn = open_write(path)
    try:
        valid = schema_columns(conn)
        validate_condition(condition, valid)
        valid_lower = {c.lower() for c in valid}
        for col in updates:
            if col == SUBSET_COLUMN:
                raise FilteringError("Cannot update the _subset_ column")
            if not is_valid_column_name(col):
                raise FilteringError(f"Invalid column name '{col}'")
            if col.lower() not in valid_lower:
                raise FilteringError(f"Unknown column '{col}' in updates")

        affected = [
            int(r[0])
            for r in conn.execute(
                _subset_query(conn, condition), [_to_sql(p) for p in parameters]
            )
        ]
        if not affected:
            return 0
        split = _is_split(conn)
        conn.execute("BEGIN")
        updated = 0
        if split:
            thin_updates = {
                k: v for k, v in updates.items() if _is_thin_column(k)
            }
            fat_updates = {
                k: v for k, v in updates.items() if not _is_thin_column(k)
            }
            for chunk in _chunks(affected, SQLITE_PARAM_LIMIT):
                qs = ", ".join(["?"] * len(chunk))
                if thin_updates:
                    set_sql = ", ".join(f'"{c}" = ?' for c in thin_updates)
                    conn.execute(
                        f"UPDATE METADATA SET {set_sql} "
                        f'WHERE "{SUBSET_COLUMN}" IN ({qs})',
                        [_to_sql(v) for v in thin_updates.values()] + chunk,
                    )
                if fat_updates:
                    set_sql = ", ".join(f'"{c}" = ?' for c in fat_updates)
                    conn.execute(
                        f"UPDATE {CONTENT_TABLE} SET {set_sql} WHERE "
                        f'"{CONTENT_ID_COLUMN}" IN (SELECT "{CONTENT_ID_COLUMN}" '
                        f'FROM METADATA WHERE "{SUBSET_COLUMN}" IN ({qs}))',
                        [_to_sql(v) for v in fat_updates.values()] + chunk,
                    )
            updated = len(affected)
        else:
            set_sql = ", ".join(f'"{c}" = ?' for c in updates)
            cur = conn.execute(
                f"UPDATE METADATA SET {set_sql} WHERE {condition}",
                [_to_sql(v) for v in updates.values()]
                + [_to_sql(p) for p in parameters],
            )
            updated = cur.rowcount
        conn.execute("COMMIT")
        invalidate_read_connection(index_path)
    except BaseException:
        try:
            conn.execute("ROLLBACK")
        except sqlite3.Error:
            pass
        raise
    finally:
        conn.close()

    if updated > 0 and affected:
        from nextplaid_tpu_torch.filtering import text_search

        text_search.update_rows(index_path, affected)
    return updated


def count(index_path) -> int:
    path = db_path(index_path)
    if not path.exists():
        return 0
    with _ReadConn(path) as conn:
        return int(conn.execute("SELECT COUNT(*) FROM METADATA").fetchone()[0])
