"""The metadata store and FTS5 keyword search, run side by side in both
packages: the same sequence of calls on two index directories must return
equal rows, ids and ranks, and FTS scores within 1e-6.

`nextplaid_tpu_torch.filtering` is a copy of `nextplaid_tpu.filtering` (both
are jax-free host code); these tests hold the copy to the reference as the
mutations use it: create, append, delete with id resequencing, filtered
subsets, and FTS index / delete / rebuild / search.
"""

import numpy as np
import pytest

from nextplaid_tpu import filtering as J
from nextplaid_tpu.filtering import text_search as JT
from nextplaid_tpu.utils.errors import FilteringError as JFilteringError
from nextplaid_tpu_torch import filtering as T
from nextplaid_tpu_torch.filtering import text_search as TT
from nextplaid_tpu_torch.utils.errors import FilteringError as TFilteringError

SCORE_TOL = 1e-6
WORDS = ("alpha", "beta", "gamma", "delta", "quick", "fox", "sort", "tensor",
         "kernel", "index", "search", "vector")


def _rows(n, seed, start=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        words = " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 6))
        rows.append({
            "year": int(rng.integers(1990, 2025)),
            "score": float(np.round(rng.uniform(0, 1), 3)),
            "title": f"doc{start + i} {words}",
            "tag": ["red", "green", "blue"][i % 3],
        })
    return rows


class Both:
    """One directory per package; `call` runs a function of each package on
    its own directory and returns both results."""

    def __init__(self, tmp_path):
        self.jp = str(tmp_path / "jax")
        self.tp = str(tmp_path / "torch")

    def call(self, jf, tf, *args, **kw):
        return jf(self.jp, *args, **kw), tf(self.tp, *args, **kw)


def _same_search(a, b):
    (ids_a, s_a), (ids_b, s_b) = a, b
    assert ids_a == ids_b
    np.testing.assert_allclose(s_a, s_b, rtol=0, atol=SCORE_TOL)


@pytest.fixture
def both(tmp_path):
    b = Both(tmp_path)
    rows = _rows(40, 0)
    ids = list(range(40))
    assert b.call(J.create, T.create, rows, ids) == (40, 40)
    b.call(JT.index, TT.index, rows, ids, tokenizer="unicode61")
    return b


# (name, condition, parameters) for where_condition / get.
CONDITIONS = (
    ("range", "year > ?", [2005]),
    ("and-or", "(year BETWEEN ? AND ?) OR tag = ?", [1995, 2000, "red"]),
    ("in", "tag IN (?, ?)", ["green", "blue"]),
    ("like", "title LIKE ?", ["%quick%"]),
    ("not-null", "score IS NOT NULL AND score < ?", [0.5]),
)


@pytest.mark.parametrize("cond", CONDITIONS, ids=[c[0] for c in CONDITIONS])
def test_where_condition_and_get(both, cond):
    _, condition, params = cond
    a, b = both.call(J.where_condition, T.where_condition, condition, params)
    assert a == b and a
    ra, rb = both.call(J.get, T.get, condition, params)
    assert ra == rb
    ra, rb = both.call(J.get, T.get, subset=a[::-1])
    assert ra == rb


@pytest.mark.parametrize("query", ["quick", "quick fox", "doc7", "tensor kernel", "nomatch"])
def test_fts_search(both, query):
    _same_search(*both.call(JT.search, TT.search, query, 10))


def test_update_delete_rebuild_sequence(both):
    """Append rows with a new column, delete a middle set (ids resequence),
    delete a suffix from FTS, rebuild: each step agrees."""
    more = _rows(15, 1, start=40)
    for r in more:
        r["extra"] = len(r["title"])
    ids = list(range(40, 55))
    assert both.call(J.update, T.update, more, ids) == (15, 15)
    both.call(JT.index, TT.index, more, ids, tokenizer="unicode61")
    assert both.call(J.count, T.count) == (55, 55)
    _same_search(*both.call(JT.search, TT.search, "doc45", 5))

    assert both.call(J.delete, T.delete, [3, 10, 11, 30]) == (4, 4)
    both.call(JT.rebuild, TT.rebuild)
    ra, rb = both.call(J.get, T.get)
    assert ra == rb and len(ra) == 51
    for q in ("doc12", "quick", "alpha beta"):
        _same_search(*both.call(JT.search, TT.search, q, 10))

    # Suffix delete: FTS rows stay aligned, only the tail goes.
    assert both.call(J.delete, T.delete, [49, 50]) == (2, 2)
    both.call(JT.delete, TT.delete, [49, 50])
    a, b = both.call(J.where_condition, T.where_condition, "extra > ?", [0])
    assert a == b
    for q in ("doc54", "doc52", "gamma"):
        _same_search(*both.call(JT.search, TT.search, q, 10))


def test_update_where_and_distinct(both):
    a, b = both.call(J.update_where, T.update_where, "tag = ?", ["red"], {"tag": "crimson"})
    assert a == b and a > 0
    a, b = both.call(J.get_distinct_strings, T.get_distinct_strings, "tag")
    assert a == b and "crimson" in a
    a, b = both.call(J.where_condition_regexp, T.where_condition_regexp, "title REGEXP ?", ["^doc1[0-9] "])
    assert a == b and a
    _same_search(*both.call(JT.search_filtered, TT.search_filtered, "quick", 10, list(range(0, 40, 2))))


@pytest.mark.parametrize(
    "condition",
    ["year > 1; DROP TABLE METADATA", "nosuchcolumn = ?", "year = 5", "(SELECT 1)"],
)
def test_rejected_conditions(both, condition):
    with pytest.raises(JFilteringError):
        J.where_condition(both.jp, condition, [1])
    with pytest.raises(TFilteringError):
        T.where_condition(both.tp, condition, [1])


@pytest.mark.parametrize("tokenizer", ["trigram", "identifier_aware"])
def test_other_tokenizers(tmp_path, tokenizer):
    b = Both(tmp_path)
    rows = [{"code": "parseHttpRequest handles snake_case_name"},
            {"code": "TensorCoreKernel launch"}, {"code": "http_request_parser"}]
    b.call(J.create, T.create, rows, [0, 1, 2])
    b.call(JT.index, TT.index, rows, [0, 1, 2], tokenizer=tokenizer)
    for q in ("request", "kernel", "snake"):
        _same_search(*b.call(JT.search, TT.search, q, 5))


def test_fusion_helpers_agree():
    sem = ([3, 1, 7, 2], [0.9, 0.8, 0.5, 0.1])
    kw = ([7, 3, 9], [4.0, 2.0, 1.0])
    assert JT.fuse_rrf(sem[0], kw[0], 0.6, 3) == TT.fuse_rrf(sem[0], kw[0], 0.6, 3)
    assert JT.fuse_relative_score(*sem, *kw, 0.3, 4) == TT.fuse_relative_score(*sem, *kw, 0.3, 4)
    for q in ('he said "hi"', "a AND b*", "(x)"):
        assert JT.sanitize_fts5_query(q) == TT.sanitize_fts5_query(q)
