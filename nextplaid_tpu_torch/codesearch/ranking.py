"""Post-fusion ranking signals for code search.

Behavioral rebuild of the reference's ranking module
(colgrep/src/ranking.rs): multiplicative file-path noise
penalties (tests 0.3 / barrels 0.5 / .d.ts 0.7), definition-name boost,
file-path stem boost (exact + prefix), and file-coherence boost. All
constants overridable via the same COLGREP_* env vars."""

from __future__ import annotations

import os
import re
from pathlib import PurePosixPath
from typing import Callable, List

from nextplaid_tpu_torch.filtering.text_search import tokenize_identifiers


def _env_f32(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v in ("1", "true", "TRUE", "yes")


_TEST_FILE_RE = re.compile(
    r"(?:^|/)(?:"
    r"test_[^/]*\.py|[^/]*_test\.py|[^/]*_test\.go|[^/]*Tests?\.java"
    r"|[^/]*Test\.php|[^/]*_spec\.rb|[^/]*_test\.rb"
    r"|[^/]*\.test\.[jt]sx?|[^/]*\.spec\.[jt]sx?"
    r"|[^/]*Tests?\.kt|[^/]*Spec\.kt|[^/]*Tests?\.swift|[^/]*Spec\.swift"
    r"|[^/]*Tests?\.cs|test_[^/]*\.(?:cpp|cc|cxx)|[^/]*_test\.(?:cpp|cc|cxx)"
    r"|test_[^/]*\.c|[^/]*_test\.c|[^/]*Spec\.scala|[^/]*Suite\.scala"
    r"|[^/]*Test\.scala|[^/]*_test\.dart|test_[^/]*\.dart"
    r"|[^/]*_spec\.lua|[^/]*_test\.lua|test_[^/]*\.lua"
    r"|[^/]*_test\.rs|tests\.rs|[^/]*_test\.exs"
    r"|[^/]*Spec\.hs|[^/]*Test\.hs|test_[^/]*\.ml|[^/]*_test\.ml"
    r"|test[-_][^/]*\.[rR]|[^/]*_test\.zig|test_[^/]*\.zig"
    r"|runtests\.jl|test_[^/]*\.jl|[^/]*_test\.jl"
    r"|[^/]*\.test\.vue|[^/]*\.spec\.vue|[^/]*\.test\.svelte"
    r"|[^/]*\.spec\.svelte|tst_[^/]*\.qml|[^/]*\.bats"
    r"|test_[^/]*\.(?:sh|bash|zsh)|[^/]*_test\.(?:sh|bash|zsh)"
    r"|[^/]*\.Tests\.ps1|test_helpers?[^/]*\.\w+"
    r")$"
)
_TEST_DIR_RE = re.compile(r"(?:^|/)(?:tests?|__tests__|spec|testing)(?:/|$)")
_COMPAT_DIR_RE = re.compile(r"(?:^|/)(?:compat|_compat|legacy)(?:/|$)")
_EXAMPLES_DIR_RE = re.compile(r"(?:^|/)(?:_?examples?|docs?_src)(?:/|$)")


def file_path_penalty(file: str) -> float:
    """Multiplicative noise penalty for test/compat/example/barrel paths
    (ranking.rs:132-156); same-category matches apply once."""
    strong = _env_f32("COLGREP_STRONG_PENALTY", 0.30)
    moderate = _env_f32("COLGREP_MODERATE_PENALTY", 0.50)
    mild = _env_f32("COLGREP_MILD_PENALTY", 0.70)
    normalized = file.replace("\\", "/")
    penalty = 1.0
    if _TEST_FILE_RE.search(normalized) or _TEST_DIR_RE.search(normalized):
        penalty *= strong
    if _COMPAT_DIR_RE.search(normalized):
        penalty *= strong
    if _EXAMPLES_DIR_RE.search(normalized):
        penalty *= strong
    if normalized.endswith(".d.ts"):
        penalty *= mild
    name = PurePosixPath(normalized).name
    if name in ("__init__.py", "package-info.java"):
        penalty *= moderate
    return penalty


def should_apply_path_penalty(query: str) -> bool:
    """Skip the penalty when the user is asking FOR test/spec/bench code."""
    q = query.lower()
    return not ("test" in q or "spec" in q or "benchmark" in q)


_STEM_STOPWORDS = frozenset(
    "a an and are as at be by do does for from has have how if in into is it "
    "its of on or so that the their then there these this to was were what "
    "when where which who why with".split()
)


def apply_definition_boost(
    items: List,
    query: str,
    name: Callable,
    is_definition: Callable,
    get_score: Callable,
    set_score: Callable,
) -> None:
    """+COLGREP_DEF_BOOST * max_score when a query token matches a unit's
    defined name (ranking.rs:191-229)."""
    if not items:
        return
    max_score = max(get_score(i) for i in items)
    if not (max_score > 0):
        return
    query_tokens = set(tokenize_identifiers(query))
    if not query_tokens:
        return
    boost = max_score * _env_f32("COLGREP_DEF_BOOST", 0.25)
    for item in items:
        if not is_definition(item):
            continue
        n = (name(item) or "").lower()
        if not n:
            continue
        if any(t in query_tokens for t in tokenize_identifiers(n)):
            set_score(item, get_score(item) + boost)


def apply_path_stem_boost(
    items: List,
    query: str,
    file_path: Callable,
    get_score: Callable,
    set_score: Callable,
) -> None:
    """+COLGREP_STEM_BOOST * max_score on exact stem-token hit, prefix hits
    get COLGREP_STEM_PREFIX_BOOST (ranking.rs:280-372)."""
    if not items:
        return
    max_score = max(get_score(i) for i in items)
    if not (max_score > 0):
        return
    stopwords = (
        _STEM_STOPWORDS
        if _env_flag("COLGREP_STEM_STOPWORDS", True)
        else frozenset()
    )
    query_tokens = {
        t for t in tokenize_identifiers(query) if t not in stopwords
    }
    if not query_tokens:
        return
    plural_snake = _env_flag("COLGREP_STEM_PLURAL_SNAKE", True)

    def variants(s: str) -> List[str]:
        out = [s]
        if plural_snake:
            stripped = s.replace("_", "")
            if stripped != s:
                out.append(stripped)
            if s.endswith("s") and len(s) > 1:
                out.append(s[:-1])
        return out

    max_boost = max_score * _env_f32("COLGREP_STEM_BOOST", 0.40)
    prefix_boost = max_score * _env_f32("COLGREP_STEM_PREFIX_BOOST", 0.20)
    for item in items:
        stem = PurePosixPath(file_path(item).replace("\\", "/")).stem.lower()
        if not stem:
            continue
        stem_tokens = tokenize_identifiers(stem)
        exact = prefix = False
        for qtok in query_tokens:
            qvars = variants(qtok)
            for stok in stem_tokens:
                svars = variants(stok)
                if any(sv == qv for sv in svars for qv in qvars):
                    exact = True
                    break
                for sv in svars:
                    for qv in qvars:
                        short, long = (sv, qv) if len(sv) <= len(qv) else (qv, sv)
                        if len(short) >= 3 and long.startswith(short):
                            prefix = True
            if exact:
                break
        if exact:
            set_score(item, get_score(item) + max_boost)
        elif prefix:
            set_score(item, get_score(item) + prefix_boost)


def apply_file_coherence_boost(
    items: List,
    file_path: Callable,
    get_score: Callable,
    set_score: Callable,
) -> None:
    """One boost per file on its top unit, scaled by the file's share of the
    candidate pool's score mass (ranking.rs:396-444)."""
    if not items:
        return
    max_score = max(get_score(i) for i in items)
    if not (max_score > 0):
        return
    per_file: dict = {}  # path -> [sum, top_idx]
    for i, item in enumerate(items):
        path = file_path(item)
        s = get_score(item)
        if path in per_file:
            per_file[path][0] += s
            if s > get_score(items[per_file[path][1]]):
                per_file[path][1] = i
        else:
            per_file[path] = [s, i]
    max_sum = max(v[0] for v in per_file.values())
    if not (max_sum > 0):
        return
    boost_unit = max_score * _env_f32("COLGREP_COHERENCE_BOOST", 0.20)
    for total, idx in per_file.values():
        set_score(items[idx], get_score(items[idx]) + boost_unit * total / max_sum)
