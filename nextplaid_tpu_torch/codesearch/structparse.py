"""Token-level structural parser for the top non-Python languages.

Replaces regex line-anchoring with a real two-phase
design mirroring what the reference gets from tree-sitter
(colgrep/src/parser/{extract.rs:1-825, analysis.rs:1-1323}),
built from scratch since tree-sitter grammars are not in this image:

  phase 1 — LEXER: language-aware tokenizer producing (kind, text, line)
    tokens with comments and strings as single tokens. This is what regex
    extraction fundamentally cannot do: braces/keywords inside strings and
    comments no longer exist, so block extents and call detection are
    reliable.
  phase 2 — RECOGNIZERS: per-language definition-head recognition over the
    token stream (functions, methods, classes/structs/traits/impls), with
    token-bracket-matched parameter lists, block extents by brace matching
    (or `end`-keyword tracking for Ruby), docstrings from adjacent comment
    runs, and layers 2-4 (calls, control flow, variables) computed from the
    unit's token slice.

Languages: javascript, typescript, go, rust, java, c, cpp, csharp, ruby,
kotlin, swift, scala, php, lua, julia, elixir, r, zig, haskell, ocaml,
sql, css, qml (reference grammar list: colgrep/src/parser/types.rs:57-97).
Vue/Svelte/HTML single-file components route their script/style blocks
here via codesearch/webformats.py. Anything else falls back to the regex
layer in parser.py.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from nextplaid_tpu_torch.codesearch.types import CodeUnit, UnitType

# Token kinds
ID, PUNCT, STR, COMMENT, NUM = "id", "punct", "str", "comment", "num"

_ID_START = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_$"
)
_ID_CONT = _ID_START | frozenset("0123456789")
_DIGITS = frozenset("0123456789")


@dataclass
class Tok:
    kind: str
    text: str
    line: int
    col: int = 0

    def __repr__(self):  # pragma: no cover - debug aid
        return f"{self.kind}:{self.text!r}@{self.line}"


@dataclass(frozen=True)
class LexCfg:
    line_comments: Tuple[str, ...]
    block_comments: Tuple[Tuple[str, str], ...] = (("/*", "*/"),)
    nested_blocks: bool = False
    backtick_string: bool = False  # Go raw / JS template
    rust_raw: bool = False
    ruby: bool = False
    triple_quote: bool = False  # Kotlin/Swift/Scala """...""" raw strings
    heredoc: bool = False  # PHP <<<ID ... ID;
    lua_long: bool = False  # Lua [[...]] / [=[...]=] long strings
    dollar_quote: bool = False  # SQL $$...$$ / $tag$...$tag$ bodies
    prime_idents: bool = False  # Haskell/OCaml foo' identifiers
    # `'` opens a char literal only when it closes within a few chars
    # (Julia adjoint `A'`, Zig, Haskell/OCaml where `'` is also an
    # identifier char) — otherwise it lexes as punctuation.
    short_char_only: bool = False
    zig_multiline: bool = False  # Zig \\...  line strings


_LEX: Dict[str, LexCfg] = {
    "javascript": LexCfg(("//",), backtick_string=True),
    "typescript": LexCfg(("//",), backtick_string=True),
    "go": LexCfg(("//",), backtick_string=True),
    "rust": LexCfg(("//",), nested_blocks=True, rust_raw=True),
    "java": LexCfg(("//",)),
    "c": LexCfg(("//",)),
    "cpp": LexCfg(("//",)),
    "csharp": LexCfg(("//",)),
    "ruby": LexCfg(("#",), block_comments=(("=begin", "=end"),), ruby=True),
    "kotlin": LexCfg(("//",), nested_blocks=True, triple_quote=True),
    "swift": LexCfg(("//",), nested_blocks=True, triple_quote=True),
    "scala": LexCfg(("//",), nested_blocks=True, triple_quote=True),
    "php": LexCfg(("//", "#"), heredoc=True),
    # --- further grammars (reference grammar list, types.rs:57-97) ---
    "lua": LexCfg(
        ("--",),
        block_comments=(("--[[", "]]"), ("--[=[", "]=]")),
        lua_long=True,
    ),
    "julia": LexCfg(
        ("#",),
        block_comments=(("#=", "=#"),),
        nested_blocks=True,
        triple_quote=True,
        backtick_string=True,
        short_char_only=True,
    ),
    "elixir": LexCfg(("#",), block_comments=(), triple_quote=True),
    "r": LexCfg(("#",), block_comments=()),
    "zig": LexCfg(
        ("//",), block_comments=(), zig_multiline=True, short_char_only=True
    ),
    "haskell": LexCfg(
        ("--",),
        block_comments=(("{-", "-}"),),
        nested_blocks=True,
        prime_idents=True,
        short_char_only=True,
    ),
    "ocaml": LexCfg(
        (),
        block_comments=(("(*", "*)"),),
        nested_blocks=True,
        prime_idents=True,
        short_char_only=True,
    ),
    "sql": LexCfg(("--",), dollar_quote=True, backtick_string=True),
    "css": LexCfg(()),
    "qml": LexCfg(("//",)),
}

SUPPORTED = frozenset(_LEX)


def tokenize(content: str, language: str) -> List[Tok]:
    cfg = _LEX[language]
    toks: List[Tok] = []
    i, line, n = 0, 1, len(content)
    line_start = 0
    while i < n:
        ch = content[i]
        if ch == "\n":
            line += 1
            i += 1
            line_start = i
            continue
        if ch in " \t\r":
            i += 1
            continue
        col = i - line_start
        # Comments. Block comments FIRST: several added grammars have a
        # block opener that extends a line opener (`--[[` vs `--`,
        # `#=` vs `#`), so the longer match must win.
        matched = False
        for bo, bc in cfg.block_comments:
            if content.startswith(bo, i):
                if cfg.ruby and col != 0:
                    break  # =begin only at column 0
                depth, j = 1, i + len(bo)
                while j < n and depth:
                    if cfg.nested_blocks and content.startswith(bo, j):
                        depth += 1
                        j += len(bo)
                    elif content.startswith(bc, j):
                        depth -= 1
                        j += len(bc)
                    else:
                        j += 1
                text = content[i:j]
                toks.append(Tok(COMMENT, text, line, col))
                line += text.count("\n")
                i = j
                nl = content.rfind("\n", 0, j)
                line_start = nl + 1 if nl >= 0 else line_start
                matched = True
                break
        if matched:
            continue
        for lc in cfg.line_comments:
            if content.startswith(lc, i):
                j = content.find("\n", i)
                j = n if j < 0 else j
                toks.append(Tok(COMMENT, content[i:j], line, col))
                i = j
                matched = True
                break
        if matched:
            continue
        # Triple-quoted raw strings (Kotlin/Swift/Scala) — must win over
        # the single-quote branch or the first two quotes parse as an empty
        # string and the third opens an unterminated one.
        if cfg.triple_quote and content.startswith('"""', i):
            k = content.find('"""', i + 3)
            k = n if k < 0 else k + 3
            text = content[i:k]
            toks.append(Tok(STR, text, line, col))
            line += text.count("\n")
            i = k
            nl = content.rfind("\n", 0, k)
            line_start = nl + 1 if nl >= 0 else line_start
            continue
        # PHP heredoc/nowdoc: <<<ID or <<<'ID' ... ID (terminator at line
        # start); braces inside must not corrupt extents.
        if cfg.heredoc and content.startswith("<<<", i):
            j = i + 3
            while j < n and content[j] in " \t":
                j += 1
            quote = content[j] if j < n and content[j] in "'\"" else ""
            if quote:
                j += 1
            m0 = j
            while j < n and (content[j].isalnum() or content[j] == "_"):
                j += 1
            ident = content[m0:j]
            if ident:
                close = re.compile(
                    r"^[ \t]*" + re.escape(ident) + r"\b", re.M
                )
                mm = close.search(content, j)
                k = mm.end() if mm else n
                text = content[i:k]
                toks.append(Tok(STR, text, line, col))
                line += text.count("\n")
                i = k
                nl = content.rfind("\n", 0, k)
                line_start = nl + 1 if nl >= 0 else line_start
                continue
        # Rust raw strings r"..." / r#"..."#.
        if cfg.rust_raw and ch == "r" and i + 1 < n and content[i + 1] in '#"':
            j = i + 1
            hashes = 0
            while j < n and content[j] == "#":
                hashes += 1
                j += 1
            if j < n and content[j] == '"':
                close = '"' + "#" * hashes
                k = content.find(close, j + 1)
                k = n if k < 0 else k + len(close)
                text = content[i:k]
                toks.append(Tok(STR, text, line, col))
                line += text.count("\n")
                i = k
                nl = content.rfind("\n", 0, k)
                line_start = nl + 1 if nl >= 0 else line_start
                continue
        # Lua long strings [[...]] / [=[...]=].
        if cfg.lua_long and ch == "[" and content[i + 1 : i + 2] in "[=":
            m = re.match(r"\[(=*)\[", content[i:])
            if m:
                close = "]" + m.group(1) + "]"
                k = content.find(close, i + m.end())
                k = n if k < 0 else k + len(close)
                text = content[i:k]
                toks.append(Tok(STR, text, line, col))
                line += text.count("\n")
                i = k
                nl = content.rfind("\n", 0, k)
                line_start = nl + 1 if nl >= 0 else line_start
                continue
        # SQL dollar-quoted bodies: $$...$$ or $tag$...$tag$ as ONE token —
        # semicolons/keywords inside a plpgsql body must not end statements.
        if cfg.dollar_quote and ch == "$":
            m = re.match(r"\$([A-Za-z_]\w*)?\$", content[i:])
            if m:
                tag = m.group(0)
                k = content.find(tag, i + len(tag))
                k = n if k < 0 else k + len(tag)
                text = content[i:k]
                toks.append(Tok(STR, text, line, col))
                line += text.count("\n")
                i = k
                nl = content.rfind("\n", 0, k)
                line_start = nl + 1 if nl >= 0 else line_start
                continue
        # Zig multiline string lines: \\ ... to end of line.
        if cfg.zig_multiline and content.startswith("\\\\", i):
            j = content.find("\n", i)
            j = n if j < 0 else j
            toks.append(Tok(STR, content[i:j], line, col))
            i = j
            continue
        # Strings.
        if ch in "\"'" or (cfg.backtick_string and ch == "`"):
            if ch == "'" and cfg.short_char_only:
                # Char literal only when it closes within a few chars
                # ('x', '\n', '\\'); otherwise `'` is punctuation (Julia
                # adjoint, Haskell/OCaml prime names).
                m = re.match(r"'(?:\\.|[^'\\\n]){1,2}'", content[i:])
                if m:
                    toks.append(Tok(STR, m.group(0), line, col))
                    i += m.end()
                else:
                    toks.append(Tok(PUNCT, "'", line, col))
                    i += 1
                continue
            q = ch
            j = i + 1
            while j < n:
                c = content[j]
                if c == "\\" and q != "`" and not cfg.dollar_quote:
                    j += 2
                    continue
                if c == q:
                    # SQL doubled-quote escape: '' inside a string.
                    if cfg.dollar_quote and content[j + 1 : j + 2] == q:
                        j += 2
                        continue
                    j += 1
                    break
                if c == "\n" and q not in "`":
                    break  # unterminated on this line; bail
                j += 1
            text = content[i:j]
            toks.append(Tok(STR, text, line, col))
            line += text.count("\n")
            i = j
            nl = content.rfind("\n", 0, j)
            line_start = nl + 1 if nl >= 0 else line_start
            continue
        # Identifiers / keywords.
        if ch in _ID_START:
            j = i + 1
            while j < n and (
                content[j] in _ID_CONT
                or (cfg.prime_idents and content[j] == "'")
            ):
                j += 1
            toks.append(Tok(ID, content[i:j], line, col))
            i = j
            continue
        # Numbers.
        if ch in _DIGITS:
            j = i + 1
            while j < n and (content[j] in _ID_CONT or content[j] == "."):
                j += 1
            toks.append(Tok(NUM, content[i:j], line, col))
            i = j
            continue
        # Multi-char operators we care about.
        for op in ("=>", "->", "::", ":=", "<<-", "<-"):
            if content.startswith(op, i):
                toks.append(Tok(PUNCT, op, line, col))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        toks.append(Tok(PUNCT, ch, line, col))
        i += 1
    return toks


# ---------------------------------------------------------------------------
# Shared analysis over a token slice (layers 2-4)
# ---------------------------------------------------------------------------

_CONTROL_KW = frozenset(
    "if else elif elsif elseif unless switch match case when for while "
    "until loop repeat do catch rescue except finally ensure defer "
    "select cond".split()
)
_LOOP_KW = frozenset("for while until loop repeat".split())
_BRANCH_KW = frozenset(
    "if elif elsif elseif unless switch match case when select cond".split()
)
_ERROR_KW = frozenset(
    "try catch rescue except finally ensure throw raise panic recover "
    "unwrap expect Err defer".split()
)
_NOT_CALLS = frozenset(
    "if else for while switch match case return new delete typeof sizeof "
    "catch throw try do break continue yield await async function fn def "
    "class struct enum impl trait interface pub use import from assert "
    "loop unless until when rescue raise begin end module require public "
    "private protected static final const let var val mut ref type where "
    "select defer go chan Some None Ok Err Box super this self "
    "then elseif local repeat defmodule defp defmacro defmacrop cond "
    "with macro mutable abstract primitive signal property".split()
)
_DECL_KW = frozenset("let const var val mut".split())


def _analyze(toks: Sequence[Tok], own_name: str, language: str = ""):
    """(calls, complexity, loops, branches, errors, variables)."""
    calls: List[str] = []
    seen = set()
    variables: List[str] = []
    vseen = set()
    complexity = 1
    loops = branches = errors = False
    for k, t in enumerate(toks):
        if t.kind != ID:
            continue
        w = t.text
        if w in _CONTROL_KW:
            if w in _LOOP_KW:
                loops = True
            if w in _BRANCH_KW:
                branches = True
            if w in ("if", "elif", "elsif", "elseif", "unless", "for",
                     "while", "until", "repeat", "case", "when", "cond",
                     "catch", "rescue", "except"):
                complexity += 1
        if w in _ERROR_KW:
            errors = True
        nxt = toks[k + 1] if k + 1 < len(toks) else None
        prv = toks[k - 1] if k > 0 else None
        # Layer 2: calls — IDENT '(' (incl. generic turbofish foo::<T>( via
        # the '::' skip below being unnecessary: name token is still foo).
        if (
            nxt is not None
            and nxt.kind == PUNCT
            and nxt.text == "("
            and w not in _NOT_CALLS
            and w != own_name
            and not (prv is not None and prv.kind == ID and prv.text in ("fn", "func", "def", "function"))
            and w not in seen
        ):
            seen.add(w)
            calls.append(w)
        # Haskell/OCaml: function application is juxtaposition — a
        # lowercase identifier directly applied to an argument token
        # (ID/NUM/STR/paren) counts as a call.
        elif (
            language in ("haskell", "ocaml")
            and w not in _NOT_CALLS
            and w != own_name
            and w not in seen
            and w[0:1].islower()
            and nxt is not None
            and (
                nxt.kind in (ID, NUM, STR)
                or (nxt.kind == PUNCT and nxt.text == "(")
            )
            and not (prv is not None and prv.text in ("::", "|", "data",
                                                      "type", "let", "and"))
        ):
            seen.add(w)
            calls.append(w)
        # Ruby: paren-less calls — `obj.method` receivers/attrs, and bare
        # statements alone on their line (`validate`).
        elif (
            language == "ruby"
            and w not in _NOT_CALLS
            and w not in ("nil", "true", "false", "end", "self")
            and w != own_name
            and w not in seen
            and (
                (prv is not None and prv.kind == PUNCT and prv.text == ".")
                or (
                    (prv is None or prv.line != t.line)
                    and (nxt is None or nxt.line != t.line)
                    and not w[0].isupper()
                )
            )
        ):
            seen.add(w)
            calls.append(w)
        # Layer 4: declarations.
        if prv is not None and prv.kind == ID and prv.text in _DECL_KW:
            if w not in vseen and w not in _NOT_CALLS:
                vseen.add(w)
                variables.append(w)
        elif nxt is not None and nxt.kind == PUNCT and nxt.text == ":=":
            if w not in vseen:
                vseen.add(w)
                variables.append(w)
        elif (
            nxt is not None
            and nxt.kind == PUNCT
            and nxt.text == "="
            and prv is not None
            and (
                prv.kind != PUNCT
                or prv.text in ("}", ";", "{")
            )
            and w not in vseen
            and w not in _NOT_CALLS
            and (k + 2 >= len(toks) or toks[k + 2].text != "=")
        ):
            vseen.add(w)
            variables.append(w)
    return calls[:30], complexity, loops, branches, errors, variables[:20]


def _match_bracket(toks: Sequence[Tok], i: int, open_c: str, close_c: str) -> int:
    """Index of the matching close bracket for the open at i (or len)."""
    depth = 0
    for j in range(i, len(toks)):
        t = toks[j]
        if t.kind == PUNCT:
            if t.text == open_c:
                depth += 1
            elif t.text == close_c:
                depth -= 1
                if depth == 0:
                    return j
    return len(toks) - 1


def _docstring(toks: Sequence[Tok], def_idx: int, def_line: int) -> Optional[str]:
    """Contiguous comment run ending on the line(s) directly above the def.
    Leading modifiers on the def's own line (`pub fn`, `public class`) are
    skipped so the anchor is the first token of the definition's line."""
    j = def_idx - 1
    while j >= 0 and toks[j].kind != COMMENT and toks[j].line == def_line:
        j -= 1
    parts: List[str] = []
    expect = def_line - 1
    while j >= 0:
        t = toks[j]
        if t.kind == COMMENT:
            end_line = t.line + t.text.count("\n")
            if end_line in (expect, expect + 1):
                parts.append(_strip_comment(t.text))
                expect = t.line - 1
                j -= 1
                continue
        break
    if not parts:
        return None
    return "\n".join(reversed(parts))[:500] or None


def _strip_comment(text: str) -> str:
    text = text.strip()
    for p in ("///", "//!", "//", "#", "/**", "/*", "=begin"):
        if text.startswith(p):
            text = text[len(p):]
            break
    for s in ("*/", "=end"):
        if text.endswith(s):
            text = text[: -len(s)]
    lines = [
        re.sub(r"^\s*[*#]\s?", "", ln).rstrip() for ln in text.splitlines()
    ]
    return "\n".join(ln for ln in lines if ln).strip()


def _params_from_slice(
    ptoks: Sequence[Tok], language: str
) -> List[str]:
    """Parameter names from the tokens INSIDE a def's parens."""
    groups: List[List[Tok]] = [[]]
    depth = 0
    for t in ptoks:
        if t.kind == PUNCT and t.text in "([{<":
            depth += 1
        elif t.kind == PUNCT and t.text in ")]}>":
            depth -= 1
        if t.kind == PUNCT and t.text == "," and depth == 0:
            groups.append([])
        else:
            groups[-1].append(t)
    names: List[str] = []
    for g in groups:
        ids = [t for t in g if t.kind == ID]
        if not ids:
            continue
        if language in ("java", "c", "cpp", "csharp"):
            name = ids[-1].text  # type name, type *name, final Type name
        else:
            # go/rust/js/ts/ruby: name first (skip mut/self/this/ref).
            skip = {"mut", "self", "this", "ref", "readonly", "public",
                    "private", "protected"}
            pick = [t for t in ids if t.text not in skip]
            if not pick:
                continue
            name = pick[0].text
        if name not in ("void",):
            names.append(name)
    return names[:15]


# ---------------------------------------------------------------------------
# Definition recognizers
# ---------------------------------------------------------------------------


@dataclass
class RawDef:
    name: str
    unit_type: str
    def_idx: int  # token index of the head keyword / name anchor
    name_idx: int
    body_start: int  # token index of '{' (or first body token for ruby)
    body_end: int  # token index of matching '}' / 'end'
    parent: Optional[str] = None
    params: Optional[List[str]] = None
    return_type: Optional[str] = None
    extends: Optional[str] = None


_FN_KW = {
    "kotlin": {"fun"},
    "swift": {"func", "init"},
    "scala": {"def"},
    "php": {"function"},
}

_CLASS_KW = {
    "javascript": {"class"},
    "typescript": {"class", "interface", "enum"},
    "go": set(),  # via `type X struct`
    "rust": {"struct", "enum", "trait", "union"},
    "java": {"class", "interface", "enum", "record"},
    "csharp": {"class", "interface", "struct", "record", "enum"},
    "kotlin": {"class", "interface", "object"},
    "swift": {"class", "struct", "enum", "protocol", "extension", "actor"},
    "scala": {"class", "object", "trait"},
    "php": {"class", "interface", "trait", "enum"},
    "c": {"struct", "union"},
    "cpp": {"class", "struct"},
    "ruby": {"class", "module"},
}

_MODIFIERS = frozenset(
    "pub public private protected internal static final abstract sealed "
    "override virtual async unsafe export default const extern inline "
    "constexpr friend partial open data suspend".split()
)


def _find_defs(toks: List[Tok], language: str) -> List[RawDef]:
    if language == "ruby":
        return _find_defs_ruby(toks)
    if language == "lua":
        return _find_defs_lua(toks)
    if language == "julia":
        return _find_defs_julia(toks)
    if language == "elixir":
        return _find_defs_elixir(toks)
    if language in ("haskell", "ocaml"):
        return _find_defs_decl(toks, language)
    if language == "r":
        return _find_defs_r(toks)
    if language == "zig":
        return _find_defs_zig(toks)
    if language == "sql":
        return _find_defs_sql(toks)
    if language == "css":
        return _find_defs_css(toks)
    if language == "qml":
        return _find_defs_qml(toks)
    defs: List[RawDef] = []
    class_kw = _CLASS_KW.get(language, set())
    n = len(toks)
    # (end_token_idx, class_name) stack for method parenting.
    class_stack: List[Tuple[int, str]] = []

    i = 0
    while i < n:
        t = toks[i]
        while class_stack and i > class_stack[-1][0]:
            class_stack.pop()
        parent = class_stack[-1][1] if class_stack else None
        if t.kind != ID:
            i += 1
            continue
        w = t.text

        # ---- class-like definitions -------------------------------------
        if w in class_kw and i + 1 < n and toks[i + 1].kind == ID:
            name_i = i + 1
            name = toks[name_i].text
            j = name_i + 1
            extends = None
            while j < n and not (
                toks[j].kind == PUNCT and toks[j].text in "{;("
            ):
                if toks[j].kind == ID and toks[j - 1].kind == ID and toks[
                    j - 1
                ].text in ("extends", "implements"):
                    extends = extends or toks[j].text
                if language == "rust" and toks[j].text == "where":
                    break
                j += 1
            if (
                j < n
                and toks[j].text == "("
                and language in ("kotlin", "scala", "csharp")
            ):
                # Primary constructor: class Repo(val db: Db) : Base() { .
                # C# positional records land here too: record Point(int X);
                j = _match_bracket(toks, j, "(", ")") + 1
                while j < n and not (
                    toks[j].kind == PUNCT and toks[j].text in "{;"
                ):
                    if toks[j].kind == PUNCT and toks[j].text == "(":
                        # Superclass constructor call (`: Base(db)`) — skip
                        # the argument group whole, the body brace follows.
                        j = _match_bracket(toks, j, "(", ")") + 1
                        continue
                    if (
                        toks[j].kind == ID
                        and toks[j - 1].kind == ID
                        and toks[j - 1].text == "extends"
                    ):
                        extends = extends or toks[j].text
                    j += 1
                if (
                    language == "csharp"
                    and j < n
                    and toks[j].text == ";"
                ):
                    # Body-less positional record: the declaration is the
                    # whole unit.
                    defs.append(
                        RawDef(name, UnitType.CLASS, i, name_i, j, j,
                               parent=parent, extends=extends)
                    )
                    i = j + 1
                    continue
            if j < n and toks[j].text == "{":
                end = _match_bracket(toks, j, "{", "}")
                defs.append(
                    RawDef(name, UnitType.CLASS, i, name_i, j, end,
                           parent=parent, extends=extends)
                )
                if language in ("java", "csharp", "typescript", "javascript",
                                "cpp", "kotlin", "swift", "scala", "php",
                                "rust"):
                    # rust: trait bodies parent their default-method fns
                    # (struct/enum bodies hold no fns, so pushing is inert).
                    class_stack.append((end, name))
                i = j + 1
                continue
            i = j + 1
            continue

        # ---- go: func / type --------------------------------------------
        if language == "go" and w == "func":
            j = i + 1
            recv = None
            # Var-bound closure: inner := func(...) T { ... } — named by
            # the binding (tree-sitter's short_var_declaration handling).
            if (
                j < n
                and toks[j].text == "("
                and i >= 2
                and toks[i - 1].kind == PUNCT
                and toks[i - 1].text in (":=", "=")
                and toks[i - 2].kind == ID
            ):
                p_close = _match_bracket(toks, j, "(", ")")
                body = p_close + 1
                while body < n and not (
                    toks[body].kind == PUNCT and toks[body].text in "{;"
                ):
                    body += 1
                if body < n and toks[body].text == "{":
                    end = _match_bracket(toks, body, "{", "}")
                    defs.append(
                        RawDef(
                            toks[i - 2].text, UnitType.FUNCTION, i - 2,
                            i - 2, body, end, parent=parent,
                            params=_params_from_slice(
                                toks[j + 1 : p_close], language
                            ),
                        )
                    )
                    i = body + 1
                    continue
            if j < n and toks[j].text == "(":
                close = _match_bracket(toks, j, "(", ")")
                ids = [t2 for t2 in toks[j:close] if t2.kind == ID]
                recv = ids[-1].text if ids else None
                j = close + 1
            if j < n and toks[j].kind == ID:
                name_i = j
                name = toks[name_i].text
                p_open = name_i + 1
                # Go 1.18 generics: func F[T any](...) — skip the type-
                # parameter bracket group before the parameter list.
                if p_open < n and toks[p_open].text == "[":
                    p_open = _match_bracket(toks, p_open, "[", "]") + 1
                if p_open < n and toks[p_open].text == "(":
                    p_close = _match_bracket(toks, p_open, "(", ")")
                    body = p_close + 1
                    while body < n and not (
                        toks[body].kind == PUNCT and toks[body].text in "{;"
                    ):
                        body += 1
                    if body < n and toks[body].text == "{":
                        end = _match_bracket(toks, body, "{", "}")
                        defs.append(
                            RawDef(
                                name,
                                UnitType.METHOD if recv else UnitType.FUNCTION,
                                i, name_i, body, end, parent=recv,
                                params=_params_from_slice(
                                    toks[p_open + 1 : p_close], language
                                ),
                            )
                        )
                        i = body + 1
                        continue
            i += 1
            continue
        if language == "go" and w == "type" and i + 2 < n:
            if toks[i + 1].kind == ID and toks[i + 2].kind == ID and toks[
                i + 2
            ].text in ("struct", "interface"):
                name_i = i + 1
                j = i + 3
                if j < n and toks[j].text == "{":
                    end = _match_bracket(toks, j, "{", "}")
                    defs.append(
                        RawDef(toks[name_i].text, UnitType.CLASS, i, name_i,
                               j, end)
                    )
                    i = end + 1
                    continue
            i += 1
            continue

        # ---- rust: fn / impl --------------------------------------------
        if language == "rust" and w == "fn" and i + 1 < n and toks[i + 1].kind == ID:
            name_i = i + 1
            name = toks[name_i].text
            j = name_i + 1
            if j < n and toks[j].text == "<":
                j = _match_bracket(toks, j, "<", ">") + 1
            if j < n and toks[j].text == "(":
                p_close = _match_bracket(toks, j, "(", ")")
                ret = None
                body = p_close + 1
                while body < n and not (
                    toks[body].kind == PUNCT and toks[body].text in "{;"
                ):
                    if toks[body].kind == PUNCT and toks[body].text == "->":
                        k2 = body + 1
                        parts = []
                        while k2 < n and not (
                            toks[k2].kind == PUNCT
                            and toks[k2].text in "{;"
                        ) and toks[k2].text != "where":
                            parts.append(toks[k2].text)
                            k2 += 1
                        ret = " ".join(parts)[:60] or None
                    body += 1
                if body < n and toks[body].text == "{":
                    end = _match_bracket(toks, body, "{", "}")
                    defs.append(
                        RawDef(
                            name,
                            UnitType.METHOD if parent else UnitType.FUNCTION,
                            i, name_i, body, end, parent=parent,
                            params=_params_from_slice(
                                toks[j + 1 : p_close], language
                            ),
                            return_type=ret,
                        )
                    )
                    i = body + 1
                    continue
            i += 1
            continue
        if language == "rust" and w == "impl":
            j = i + 1
            if j < n and toks[j].text == "<":
                j = _match_bracket(toks, j, "<", ">") + 1
            names = []
            while j < n and toks[j].text != "{" and toks[j].text != "where":
                # Skip generic argument groups whole: impl<T> Repo<T> must
                # name Repo, not the type parameter T.
                if toks[j].kind == PUNCT and toks[j].text == "<":
                    j = _match_bracket(toks, j, "<", ">") + 1
                    continue
                if toks[j].kind == ID and toks[j].text != "for":
                    names.append(toks[j].text)
                j += 1
            while j < n and toks[j].text != "{":
                j += 1
            if j < n:
                end = _match_bracket(toks, j, "{", "}")
                impl_type = names[-1] if names else None
                if impl_type:
                    class_stack.append((end, impl_type))
            i = j + 1
            continue

        # ---- kotlin/swift/scala/php: keyword-led functions ---------------
        if language in _FN_KW and w in _FN_KW[language]:
            name_i = i
            if i + 1 < n and toks[i + 1].kind == ID:
                name_i = i + 1
                # Kotlin extension receivers: fun String.ext(...) — the
                # LAST dotted segment is the name.
                while (
                    name_i + 2 < n
                    and toks[name_i + 1].text == "."
                    and toks[name_i + 2].kind == ID
                ):
                    name_i += 2
                name = toks[name_i].text
                j = name_i + 1
            elif w == "init" and i + 1 < n and toks[i + 1].text == "(":
                name = "init"  # Swift initializer
                j = i + 1
            else:
                i += 1
                continue
            # Generic parameter groups before the parens.
            if j < n and toks[j].text == "<":
                j = _match_bracket(toks, j, "<", ">") + 1
            if language == "scala" and j < n and toks[j].text == "[":
                j = _match_bracket(toks, j, "[", "]") + 1
            if j < n and toks[j].text == "(":
                p_close = _match_bracket(toks, j, "(", ")")
                ret = None
                body = p_close + 1
                while body < n and not (
                    toks[body].kind == PUNCT and toks[body].text in "{;="
                ):
                    if toks[body].kind == PUNCT and toks[body].text in (
                        ":", "->",
                    ):
                        k2 = body + 1
                        parts = []
                        while k2 < n and not (
                            toks[k2].kind == PUNCT
                            and toks[k2].text in "{;="
                        ):
                            parts.append(toks[k2].text)
                            k2 += 1
                        ret = " ".join(parts)[:60] or None
                    body += 1
                # Scala/Kotlin expression bodies (`= expr`): the unit spans
                # to the end of the logical line, with bracketed groups
                # allowed to continue across lines (fun f(x: Int): Int =
                # x + 1 is the idiomatic Kotlin single-expression form —
                # leaving it to the RawCode layer lost its signature,
                # params and call edges).
                if body < n and toks[body].text == "=":
                    nxt = body + 1
                    if nxt < n and toks[nxt].text == "{":
                        body = nxt
                    elif language in ("kotlin", "scala") and nxt < n:
                        k2 = nxt
                        last = nxt
                        while k2 < n:
                            t2 = toks[k2]
                            if t2.kind == PUNCT and t2.text in "([{":
                                close = {"(": ")", "[": "]", "{": "}"}[
                                    t2.text
                                ]
                                k2 = _match_bracket(
                                    toks, k2, t2.text, close
                                )
                                last = k2
                                k2 += 1
                                continue
                            if t2.line > toks[last].line:
                                break
                            last = k2
                            k2 += 1
                        defs.append(
                            RawDef(
                                name,
                                UnitType.METHOD
                                if parent
                                else UnitType.FUNCTION,
                                i, name_i, nxt, last, parent=parent,
                                params=_params_from_slice(
                                    toks[j + 1 : p_close], language
                                ),
                                return_type=ret,
                            )
                        )
                        i = last + 1
                        continue
                if body < n and toks[body].text == "{":
                    end = _match_bracket(toks, body, "{", "}")
                    defs.append(
                        RawDef(
                            name,
                            UnitType.METHOD if parent else UnitType.FUNCTION,
                            i, name_i, body, end, parent=parent,
                            params=_params_from_slice(
                                toks[j + 1 : p_close], language
                            ),
                            return_type=ret,
                        )
                    )
                    i = body + 1
                    continue
            i = name_i + 1
            continue

        # ---- js/ts: function / arrow / method ---------------------------
        if language in ("javascript", "typescript"):
            if w == "function":
                j = i + 1
                if j < n and toks[j].text == "*":
                    j += 1
                if j < n and toks[j].kind == ID:
                    name_i = j
                    p_open = j + 1
                    if p_open < n and toks[p_open].text == "<":
                        p_open = _match_bracket(toks, p_open, "<", ">") + 1
                    if p_open < n and toks[p_open].text == "(":
                        p_close = _match_bracket(toks, p_open, "(", ")")
                        body = p_close + 1
                        while body < n and not (
                            toks[body].kind == PUNCT
                            and toks[body].text in "{;"
                        ):
                            body += 1
                        if body < n and toks[body].text == "{":
                            end = _match_bracket(toks, body, "{", "}")
                            defs.append(
                                RawDef(
                                    toks[name_i].text, UnitType.FUNCTION, i,
                                    name_i, body, end,
                                    params=_params_from_slice(
                                        toks[p_open + 1 : p_close], language
                                    ),
                                )
                            )
                            i = body + 1
                            continue
                i += 1
                continue
            # const name = (...) => / = async (...) =>
            if (
                w in ("const", "let", "var")
                and i + 2 < n
                and toks[i + 1].kind == ID
                and toks[i + 2].text == "="
            ):
                j = i + 3
                # const obj = { ... }: an OBJECT-LITERAL scope — its
                # shorthand methods / arrow properties parent to the
                # object's name (tree-sitter extracts object methods as
                # named units; extract.rs object/method handling).
                if j < n and toks[j].text == "{":
                    end = _match_bracket(toks, j, "{", "}")
                    class_stack.append((end, toks[i + 1].text))
                    i = j + 1
                    continue
                while j < n and toks[j].kind == ID and toks[j].text == "async":
                    j += 1
                arrow_at = None
                if j < n and toks[j].text == "(":
                    p_close = _match_bracket(toks, j, "(", ")")
                    k2 = p_close + 1
                    # Skip a TS return-type annotation between ')' and '=>'.
                    if k2 < n and toks[k2].text == ":":
                        while k2 < n and toks[k2].text not in ("=>", ";", "=", "{"):
                            k2 += 1
                    if k2 < n and toks[k2].text == "=>":
                        arrow_at = k2
                        p_slice = toks[j + 1 : p_close]
                elif j + 1 < n and toks[j].kind == ID and toks[j + 1].text == "=>":
                    arrow_at = j + 1
                    p_slice = [toks[j]]
                if arrow_at is not None:
                    body = arrow_at + 1
                    if body < n and toks[body].text == "{":
                        end = _match_bracket(toks, body, "{", "}")
                    else:
                        end = body
                        depth = 0
                        while end < n:
                            te = toks[end]
                            if te.kind == PUNCT:
                                if te.text in "([{":
                                    depth += 1
                                elif te.text in ")]}":
                                    depth -= 1
                                    if depth < 0:
                                        break
                                elif te.text == ";" and depth == 0:
                                    break
                            end += 1
                        end = min(end, n - 1)
                    defs.append(
                        RawDef(
                            toks[i + 1].text, UnitType.FUNCTION, i, i + 1,
                            body, end,
                            params=_params_from_slice(p_slice, language),
                        )
                    )
                    i = body
                    continue
            # object-literal arrow property: name: (args) => ... /
            # name: async x => ... with prev "{" or "," (an object-literal
            # or class-field position; ternaries never have ID ":" "(" ")"
            # "=>" shapes after those separators).
            if (
                i + 1 < n
                and toks[i + 1].text == ":"
                and i > 0
                and toks[i - 1].kind == PUNCT
                and toks[i - 1].text in "{,"
            ):
                j = i + 2
                while j < n and toks[j].kind == ID and toks[j].text == "async":
                    j += 1
                arrow_at = None
                p_slice: List[Tok] = []
                if j < n and toks[j].text == "(":
                    p_close = _match_bracket(toks, j, "(", ")")
                    k2 = p_close + 1
                    if k2 < n and toks[k2].text == ":":
                        while k2 < n and toks[k2].text not in ("=>", ";", ",", "}"):
                            k2 += 1
                    if k2 < n and toks[k2].text == "=>":
                        arrow_at = k2
                        p_slice = toks[j + 1 : p_close]
                elif j + 1 < n and toks[j].kind == ID and toks[j + 1].text == "=>":
                    arrow_at = j + 1
                    p_slice = [toks[j]]
                if arrow_at is not None:
                    body = arrow_at + 1
                    if body < n and toks[body].text == "{":
                        end = _match_bracket(toks, body, "{", "}")
                    else:
                        end = body
                        depth = 0
                        while end < n:
                            te = toks[end]
                            if te.kind == PUNCT:
                                if te.text in "([{":
                                    depth += 1
                                elif te.text in ")]}":
                                    depth -= 1
                                    if depth < 0:
                                        break
                                elif te.text in ",;" and depth == 0:
                                    break
                            end += 1
                        end = min(end, n - 1)
                    defs.append(
                        RawDef(
                            w,
                            UnitType.METHOD if parent else UnitType.FUNCTION,
                            i, i, body, end, parent=parent,
                            params=_params_from_slice(p_slice, language),
                        )
                    )
                    i = body
                    continue
            # class-body method: IDENT [<T,...>] '(' ... ')' '{' at class
            # depth (also object-literal shorthand methods via the
            # object-scope stack). Generic methods (m<T>(x: T)) carry an
            # angle-bracket group before the parens; match it with a
            # bounded depth scan (angles are operators, not lexer brackets
            # — a short scan that must END at "(" keeps comparison chains
            # from matching).
            paren_i = None
            if parent is not None and i + 1 < n and toks[i + 1].text == "(":
                paren_i = i + 1
            elif (
                parent is not None
                and language == "typescript"
                and i + 1 < n
                and toks[i + 1].text == "<"
            ):
                depth, j2 = 0, i + 1
                while j2 < min(n, i + 96):
                    t2 = toks[j2].text
                    if t2 == "<":
                        depth += 1
                    elif t2 == ">":
                        depth -= 1
                        if depth == 0:
                            break
                    elif t2 == "{":
                        # Object types inside the parameter bound —
                        # get<V extends {b: boolean}>(...) — are balanced
                        # brace groups; skip them whole. (A bare "{" in a
                        # comparison chain still aborts via "}" / ")".)
                        j2 = _match_bracket(toks, j2, "{", "}")
                    elif t2 in (";", "}", ")"):
                        j2 = n
                        break
                    j2 += 1
                if depth == 0 and j2 + 1 < n and toks[j2 + 1].text == "(":
                    paren_i = j2 + 1
            if (
                paren_i is not None
                and w not in _NOT_CALLS
                and w not in ("constructor", "if", "for", "while", "switch",
                              "catch")
            ):
                p_close = _match_bracket(toks, paren_i, "(", ")")
                body = p_close + 1
                if body < n and toks[body].text == ":" and language == "typescript":
                    while body < n and toks[body].text != "{":
                        if toks[body].text in (";", "="):
                            body = n
                            break
                        body += 1
                if body < n and toks[body].text == "{":
                    prev = toks[i - 1] if i > 0 else None
                    if prev is None or prev.kind == COMMENT or (
                        prev.kind == PUNCT and prev.text in "{};,"
                    ) or (prev.kind == ID and prev.text in _MODIFIERS | {"get", "set"}):
                        end = _match_bracket(toks, body, "{", "}")
                        defs.append(
                            RawDef(
                                w, UnitType.METHOD, i, i, body, end,
                                parent=parent,
                                params=_params_from_slice(
                                    toks[paren_i + 1 : p_close], language
                                ),
                            )
                        )
                        i = body + 1
                        continue

        # ---- java/c#: method inside class body --------------------------
        if language in ("java", "csharp") and parent is not None:
            if (
                i + 1 < n
                and toks[i + 1].text == "("
                and w not in _NOT_CALLS
                and i > 0
                and (
                    (toks[i - 1].kind == ID and toks[i - 1].text not in
                     ("new", "return", "throw"))
                    or (toks[i - 1].kind == PUNCT and toks[i - 1].text in (">", "]"))
                )
            ):
                p_close = _match_bracket(toks, i + 1, "(", ")")
                body = p_close + 1
                while body < n and toks[body].kind == ID and toks[body].text in (
                    "throws", "where"
                ):
                    body += 1
                    while body < n and not (
                        toks[body].kind == PUNCT
                        and toks[body].text in ("{", ";", "=>")
                    ):
                        body += 1
                ret_tok = toks[i - 1]
                ret_type = (
                    ret_tok.text
                    if ret_tok.kind == ID and ret_tok.text != parent
                    else None
                )
                if body < n and toks[body].text == "{":
                    end = _match_bracket(toks, body, "{", "}")
                    defs.append(
                        RawDef(
                            w, UnitType.METHOD, i, i, body, end,
                            parent=parent,
                            params=_params_from_slice(
                                toks[i + 2 : p_close], language
                            ),
                            return_type=ret_type,
                        )
                    )
                    i = body + 1
                    continue
                if (
                    language == "csharp"
                    and body < n
                    and toks[body].text == "=>"
                ):
                    # Expression-bodied member: T Name(args) => expr; —
                    # extent runs to the statement-level semicolon.
                    end = body + 1
                    depth = 0
                    while end < n:
                        te = toks[end]
                        if te.kind == PUNCT:
                            if te.text in "([{":
                                depth += 1
                            elif te.text in ")]}":
                                depth -= 1
                                if depth < 0:
                                    break
                            elif te.text == ";" and depth == 0:
                                break
                        end += 1
                    end = min(end, n - 1)
                    defs.append(
                        RawDef(
                            w, UnitType.METHOD, i, i, body, end,
                            parent=parent,
                            params=_params_from_slice(
                                toks[i + 2 : p_close], language
                            ),
                            return_type=ret_type,
                        )
                    )
                    i = end + 1
                    continue

        # ---- cpp: method inside class body ------------------------------
        cpp_name = w
        cpp_paren = i + 1
        if (
            language == "cpp"
            and w == "operator"
            and i + 1 < n
            and toks[i + 1].kind == PUNCT
            and toks[i + 1].text != "("
        ):
            # Overloaded operator: operator+=(...) — fold the symbol tokens
            # (the lexer splits compound operators: "+","=") into the name
            # and shift the parameter list to the following "(".
            j2, sym = i + 1, ""
            while (
                j2 < n
                and j2 <= i + 3
                and toks[j2].kind == PUNCT
                and toks[j2].text != "("
            ):
                sym += toks[j2].text
                j2 += 1
            if sym and j2 < n and toks[j2].text == "(":
                cpp_name = "operator" + sym
                cpp_paren = j2
        if (
            language == "cpp"
            and parent is not None
            and cpp_paren < n
            and toks[cpp_paren].text == "("
            and w not in _NOT_CALLS
            and w not in _CONTROL_KW
            and i > 0
        ):
            prev = toks[i - 1]
            is_dtor = prev.kind == PUNCT and prev.text == "~"
            # Constructor: name == class name, led by an access specifier
            # (`public:`), a body/member boundary, the class brace, or a
            # declaration qualifier (`explicit Matrix(int n)`).
            _CPP_DECL_QUALIFIERS = ("explicit", "inline", "constexpr",
                                    "consteval", "virtual")
            is_ctor = w == parent and (
                prev.kind == COMMENT
                or (prev.kind == PUNCT and prev.text in ("{", "}", ";", ":"))
                or (prev.kind == ID and prev.text in _CPP_DECL_QUALIFIERS)
            )
            is_method = not is_ctor and (
                (
                    prev.kind == ID
                    and prev.text not in ("return", "new", "throw", "goto",
                                          "case", "delete")
                )
                or (prev.kind == PUNCT and prev.text in ("*", "&", ">"))
            )
            if is_dtor or is_ctor or is_method:
                p_close = _match_bracket(toks, cpp_paren, "(", ")")
                body = p_close + 1
                while body < n:
                    t2 = toks[body]
                    if t2.kind == ID and t2.text in (
                        "const", "noexcept", "override", "final",
                        "volatile", "try",
                    ):
                        body += 1
                        if (
                            t2.text == "noexcept"
                            and body < n
                            and toks[body].text == "("
                        ):
                            body = _match_bracket(toks, body, "(", ")") + 1
                        continue
                    if t2.kind == PUNCT and t2.text in ("&", "&&"):
                        body += 1
                        continue
                    if t2.kind == PUNCT and t2.text == "->":
                        # Trailing return type: auto f() -> T { .
                        body += 1
                        while body < n and not (
                            toks[body].kind == PUNCT
                            and toks[body].text in "{;"
                        ):
                            body += 1
                        continue
                    if t2.kind == PUNCT and t2.text == ":":
                        # Constructor-initializer list: skip the
                        # `member(expr)` / `member{expr}` groups; the body
                        # brace is the first "{" NOT preceded by an ID.
                        body += 1
                        while body < n:
                            t3 = toks[body]
                            if t3.kind == PUNCT and t3.text == "(":
                                body = _match_bracket(toks, body, "(", ")") + 1
                                continue
                            if t3.kind == PUNCT and t3.text == "{":
                                if toks[body - 1].kind == ID:
                                    body = _match_bracket(
                                        toks, body, "{", "}"
                                    ) + 1
                                    continue
                                break
                            if t3.kind == PUNCT and t3.text == ";":
                                break
                            body += 1
                        continue
                    break
                if body < n and toks[body].text == "{":
                    end = _match_bracket(toks, body, "{", "}")
                    defs.append(
                        RawDef(
                            ("~" + w) if is_dtor else cpp_name,
                            UnitType.METHOD, i, i, body, end,
                            parent=parent,
                            params=_params_from_slice(
                                toks[cpp_paren + 1 : p_close], language
                            ),
                            return_type=(
                                prev.text
                                if is_method
                                and prev.kind == ID
                                and prev.text not in _CPP_DECL_QUALIFIERS
                                else None
                            ),
                        )
                    )
                    i = body + 1
                    continue

        # ---- c/cpp: free function definitions ---------------------------
        if language in ("c", "cpp"):
            if (
                i + 1 < n
                and toks[i + 1].text == "("
                and w not in _NOT_CALLS
                and w not in _CONTROL_KW
                and i > 0
                and (
                    (toks[i - 1].kind == ID and toks[i - 1].text not in
                     ("return", "new", "throw", "goto", "case"))
                    or (toks[i - 1].kind == PUNCT and toks[i - 1].text in
                        ("*", "&", "::", ">"))
                )
                and parent is None
            ):
                p_close = _match_bracket(toks, i + 1, "(", ")")
                body = p_close + 1
                while body < n and toks[body].kind == ID and toks[body].text in (
                    "const", "noexcept", "override", "final",
                ):
                    body += 1
                if body < n and toks[body].kind == PUNCT and toks[body].text == "->":
                    # Trailing return type: auto f() -> T { .
                    body += 1
                    while body < n and not (
                        toks[body].kind == PUNCT and toks[body].text in "{;"
                    ):
                        body += 1
                if body < n and toks[body].text == "{":
                    # qualified name Class::method
                    name = w
                    par = None
                    if i >= 2 and toks[i - 1].text == "::" and toks[i - 2].kind == ID:
                        par = toks[i - 2].text
                    end = _match_bracket(toks, body, "{", "}")
                    defs.append(
                        RawDef(
                            name,
                            UnitType.METHOD if par else UnitType.FUNCTION,
                            i, i, body, end, parent=par,
                            params=_params_from_slice(
                                toks[i + 2 : p_close], language
                            ),
                        )
                    )
                    i = body + 1
                    continue
        i += 1
    return defs


_RUBY_OPENERS = frozenset(
    "def class module if unless case while until for begin do".split()
)
_RUBY_MODIFIER_OK = frozenset("if unless while until".split())


def _find_defs_ruby(toks: List[Tok]) -> List[RawDef]:
    """Ruby: `end`-matched blocks; modifier if/unless (not at line start)
    do not open blocks; `do` after while/until/for doesn't double-open."""
    n = len(toks)
    defs: List[RawDef] = []
    # First pass: compute block pairing with a stack.
    stack: List[int] = []  # token indices of openers
    match_end: Dict[int, int] = {}
    first_on_line: Dict[int, bool] = {}
    last_line = -1
    for k, t in enumerate(toks):
        if t.kind == COMMENT:
            continue
        fol = t.line != last_line
        last_line = t.line
        first_on_line[k] = fol
        if t.kind != ID:
            continue
        w = t.text
        if w in _RUBY_OPENERS:
            if w in _RUBY_MODIFIER_OK and not fol:
                continue  # modifier form: `x = 1 if cond`
            if w == "do":
                prev = toks[k - 1] if k else None
                if prev is not None and prev.kind == ID and prev.text in (
                    "while", "until", "for"
                ):
                    continue
            if w == "def":
                # Ruby 3 endless method: `def name(args) = expr` has no
                # `end`; pushing it would desync every later pairing.
                j2 = k + 1
                if j2 < len(toks) and toks[j2].kind == ID:
                    j2 += 1
                    if j2 < len(toks) and toks[j2].text == "(":
                        depth = 0
                        while j2 < len(toks):
                            if toks[j2].text == "(":
                                depth += 1
                            elif toks[j2].text == ")":
                                depth -= 1
                                if depth == 0:
                                    j2 += 1
                                    break
                            j2 += 1
                    if (
                        j2 < len(toks)
                        and toks[j2].text == "="
                        and toks[j2].line == t.line
                    ):
                        continue
            stack.append(k)
        elif w == "end":
            if stack:
                match_end[stack.pop()] = k

    class_stack: List[Tuple[int, str]] = []
    for k, t in enumerate(toks):
        if t.kind != ID or k not in match_end:
            continue
        while class_stack and k > class_stack[-1][0]:
            class_stack.pop()
        parent = class_stack[-1][1] if class_stack else None
        end = match_end[k]
        if t.text in ("class", "module") and k + 1 < n and toks[k + 1].kind == ID:
            name = toks[k + 1].text
            extends = None
            if k + 3 < n and toks[k + 2].text == "<" and toks[k + 3].kind == ID:
                extends = toks[k + 3].text
            defs.append(
                RawDef(name, UnitType.CLASS, k, k + 1, k + 2, end,
                       parent=parent, extends=extends)
            )
            class_stack.append((end, name))
        elif t.text == "def" and k + 1 < n:
            j = k + 1
            if toks[j].kind == ID and toks[j].text == "self" and j + 2 < n and toks[j + 1].text == ".":
                j += 2
            if toks[j].kind != ID:
                continue
            name = toks[j].text
            # trailing ? or ! belongs to the method name
            if j + 1 < n and toks[j + 1].kind == PUNCT and toks[j + 1].text in "?!":
                name += toks[j + 1].text
                j += 1
            params: List[str] = []
            if j + 1 < n and toks[j + 1].text == "(":
                p_close = _match_bracket(toks, j + 1, "(", ")")
                params = _params_from_slice(toks[j + 2 : p_close], "ruby")
            defs.append(
                RawDef(name, UnitType.METHOD if parent else UnitType.FUNCTION,
                       k, j, j + 1, end, parent=parent, params=params)
            )
    return defs


# ---------------------------------------------------------------------------
# Round-3 grammars: end-block languages (Lua / Julia / Elixir), declaration
# languages (Haskell / OCaml), R, Zig, SQL, CSS, QML
# (reference grammar list: colgrep/src/parser/types.rs:57-97)
# ---------------------------------------------------------------------------


def _first_on_line_flags(toks: List[Tok]) -> List[bool]:
    flags = []
    last = -1
    for t in toks:
        flags.append(t.line != last)
        last = t.line
    return flags


def _line_end_tok(toks: List[Tok], k: int) -> int:
    """Index of the last token on toks[k]'s line."""
    ln = toks[k].line
    j = k
    while j + 1 < len(toks) and toks[j + 1].line == ln:
        j += 1
    return j


def _find_defs_lua(toks: List[Tok]) -> List[RawDef]:
    """Lua: `function ... end` blocks; `for/while ... do`, `if ... then`,
    standalone `do`, and `repeat ... until` all tracked so `end` pairing
    stays in sync. Method defs `function Obj:m()` / `function Obj.m()` and
    anonymous `name = function(...)` assignments are recognized."""
    n = len(toks)
    defs: List[RawDef] = []
    stack: List[Tuple[int, str]] = []  # (token idx, kind)
    match_end: Dict[int, int] = {}
    pending_do = False  # a for/while header's `do` must not double-push
    for k, t in enumerate(toks):
        if t.kind != ID or t.kind == COMMENT:
            continue
        w = t.text
        if w in ("for", "while"):
            stack.append((k, w))
            pending_do = True
        elif w == "do":
            if pending_do:
                pending_do = False
            else:
                stack.append((k, "do"))
        elif w in ("function", "if"):
            stack.append((k, w))
        elif w == "repeat":
            stack.append((k, "repeat"))
        elif w == "until":
            if stack and stack[-1][1] == "repeat":
                match_end[stack.pop()[0]] = k
        elif w == "end":
            while stack:
                ki, kind = stack.pop()
                if kind != "repeat":  # repeat closes with until, not end
                    match_end[ki] = k
                    break
    for k, end in sorted(match_end.items()):
        if toks[k].text != "function":
            continue
        # Name chain after `function`, or assignment target before it.
        name = parent = None
        is_method = False
        j = k + 1
        if j < n and toks[j].kind == ID:
            chain = [toks[j].text]
            j += 1
            while (
                j + 1 < n
                and toks[j].kind == PUNCT
                and toks[j].text in ".:"
                and toks[j + 1].kind == ID
            ):
                is_method = is_method or toks[j].text == ":"
                chain.append(toks[j + 1].text)
                j += 2
            name = chain[-1]
            parent = ".".join(chain[:-1]) or None
        elif k >= 2 and toks[k - 1].text == "=" and toks[k - 2].kind == ID:
            name = toks[k - 2].text
            j = k + 1
        if not name:
            continue
        params: List[str] = []
        if j < n and toks[j].text == "(":
            close = _match_bracket(toks, j, "(", ")")
            params = [
                t2.text
                for t2 in toks[j + 1 : close]
                if t2.kind == ID or (t2.kind == PUNCT and t2.text == "...")
            ][:15]
            body_start = close + 1
        else:
            body_start = j
        def_idx = k - 2 if (k >= 2 and toks[k - 1].text == "=") else k
        if k >= 1 and toks[k - 1].kind == ID and toks[k - 1].text == "local":
            def_idx = k - 1
        defs.append(
            RawDef(
                name,
                UnitType.METHOD if (is_method or parent) else UnitType.FUNCTION,
                def_idx,
                k,
                min(body_start, end),
                end,
                parent=parent,
                params=params,
            )
        )
    return defs


_JULIA_OPENERS = frozenset(
    "function macro struct module baremodule if for while let begin try "
    "quote do".split()
)


def _find_defs_julia(toks: List[Tok]) -> List[RawDef]:
    """Julia: `end`-matched blocks with square-bracket tracking (`a[end]`
    is an index expression, not a terminator); `mutable struct`,
    `abstract/primitive type ... end`, modules as parents, and the
    short-form `name(args) = expr` definition."""
    n = len(toks)
    defs: List[RawDef] = []
    fol = _first_on_line_flags(toks)
    stack: List[int] = []
    match_end: Dict[int, int] = {}
    sq_depth = 0
    par_depth = 0
    for k, t in enumerate(toks):
        if t.kind == PUNCT:
            if t.text == "[":
                sq_depth += 1
            elif t.text == "]":
                sq_depth = max(sq_depth - 1, 0)
            elif t.text == "(":
                par_depth += 1
            elif t.text == ")":
                par_depth = max(par_depth - 1, 0)
            continue
        if t.kind != ID:
            continue
        w = t.text
        if sq_depth > 0 or par_depth > 0:
            # Inside brackets/parens: comprehension and generator `for`/
            # `if` (`[2x for x in xs]`, `sum(x for x in xs)`) and the
            # `begin`/`end` index keywords are NOT block openers — pushing
            # them desyncs end-pairing and silently drops any function
            # containing one. Anonymous `function...end` inside a call is
            # skipped symmetrically (both opener and its `end`), keeping
            # the pairing balanced.
            continue
        if w in _JULIA_OPENERS:
            if w == "struct" and k and toks[k - 1].text == "mutable":
                pass  # push at `struct`; `mutable` is a modifier
            stack.append(k)
        elif w == "type" and k and toks[k - 1].text in ("abstract", "primitive"):
            stack.append(k)
        elif w == "end":
            if stack:
                match_end[stack.pop()] = k

    class_stack: List[Tuple[int, str, str]] = []  # (end, name, opener kind)
    for k, t in enumerate(toks):
        while class_stack and k > class_stack[-1][0]:
            class_stack.pop()
        parent = class_stack[-1][1] if class_stack else None
        in_struct = bool(class_stack) and class_stack[-1][2] == "struct"
        if t.kind != ID:
            continue
        w = t.text
        end = match_end.get(k)
        if end is not None and w in ("struct", "module", "baremodule"):
            j = k + 1
            if j < n and toks[j].kind == ID:
                name = toks[j].text
                extends = None
                if (
                    j + 2 < n
                    and toks[j + 1].text == "<:"
                    or (j + 1 < n and toks[j + 1].text == "<"
                        and j + 2 < n and toks[j + 2].text == ":")
                ):
                    # `<:` lexes as '<' ':' — supertype follows
                    jj = j + 2 if toks[j + 1].text == "<:" else j + 3
                    if jj < n and toks[jj].kind == ID:
                        extends = toks[jj].text
                di = k - 1 if (k and toks[k - 1].text == "mutable") else k
                defs.append(
                    RawDef(name, UnitType.CLASS, di, j, j + 1, end,
                           parent=parent, extends=extends)
                )
                class_stack.append(
                    (end, name, "struct" if w == "struct" else "module")
                )
            continue
        if end is not None and w == "type" and k and toks[k - 1].text in (
            "abstract", "primitive"
        ):
            if k + 1 < n and toks[k + 1].kind == ID:
                defs.append(
                    RawDef(toks[k + 1].text, UnitType.CLASS, k - 1, k + 1,
                           k + 2, end, parent=parent)
                )
            continue
        if end is not None and w in ("function", "macro"):
            j = k + 1
            chain = []
            while j < n and toks[j].kind == ID:
                chain.append(toks[j].text)
                j += 1
                if j + 1 < n and toks[j].text == "." and toks[j + 1].kind == ID:
                    j += 1
                    continue
                break
            if not chain:
                continue
            name = chain[-1]
            params: List[str] = []
            if j < n and toks[j].text == "(":
                close = _match_bracket(toks, j, "(", ")")
                params = _params_from_slice(toks[j + 1 : close], "julia")
                j = close + 1
            defs.append(
                RawDef(
                    name,
                    # Module children stay FUNCTIONs (a module is a
                    # namespace); only inner functions of a struct body
                    # (rare, e.g. inner constructors) are methods.
                    UnitType.METHOD if in_struct else UnitType.FUNCTION,
                    k, k + 1, min(j, end), end,
                    parent=parent, params=params,
                )
            )
            continue
        # Short form `name(args) = expr` at line start.
        if (
            fol[k]
            and w not in _JULIA_OPENERS
            and k + 1 < n
            and toks[k + 1].text == "("
        ):
            close = _match_bracket(toks, k + 1, "(", ")")
            if (
                close + 1 < n
                and toks[close + 1].kind == PUNCT
                and toks[close + 1].text == "="
                and toks[close + 1].line == t.line
            ):
                le = _line_end_tok(toks, close + 1)
                defs.append(
                    RawDef(
                        w, UnitType.FUNCTION, k, k, close + 2, le,
                        parent=parent,
                        params=_params_from_slice(toks[k + 2 : close], "julia"),
                    )
                )
    return defs


_ELIXIR_DEF_KW = {
    "def": UnitType.FUNCTION,
    "defp": UnitType.FUNCTION,
    "defmacro": UnitType.FUNCTION,
    "defmacrop": UnitType.FUNCTION,
}
_ELIXIR_MOD_KW = frozenset(("defmodule", "defprotocol", "defimpl"))


def _is_elixir_kw_do(toks: List[Tok], k: int) -> bool:
    """True for the keyword-list form `do:` — the colon IMMEDIATELY
    follows `do` (same line, adjacent column, no whitespace). This is the
    only reliable discriminator: a comma precedes `, do: expr` but NOT
    `quote do: expr` / `foo(do: x)` / `[do: block]`, and a following ":"
    alone also matches a block `do` whose body starts with an atom
    (`do\\n  :ok`) or the one-line block `do :ok end` (space-separated)."""
    t = toks[k]
    nxt = toks[k + 1] if k + 1 < len(toks) else None
    return (
        nxt is not None
        and nxt.kind == PUNCT
        and nxt.text == ":"
        and nxt.line == t.line
        and nxt.col == t.col + 2
    )


def _find_defs_elixir(toks: List[Tok]) -> List[RawDef]:
    """Elixir: `do ... end` blocks (`do:` keyword form excluded),
    `fn ... end` lambdas, defmodule parents, def/defp/defmacro heads with
    guard clauses, and one-line `def name(args), do: expr` definitions."""
    n = len(toks)
    defs: List[RawDef] = []
    stack: List[int] = []
    match_end: Dict[int, int] = {}
    for k, t in enumerate(toks):
        if t.kind != ID:
            continue
        if t.text in ("do", "fn"):
            if t.text == "do" and _is_elixir_kw_do(toks, k):
                continue  # keyword form `do: expr` — not a block opener
            stack.append(k)
        elif t.text == "end":
            if stack:
                match_end[stack.pop()] = k

    class_stack: List[Tuple[int, str]] = []
    for k, t in enumerate(toks):
        while class_stack and k > class_stack[-1][0]:
            class_stack.pop()
        parent = class_stack[-1][1] if class_stack else None
        if t.kind != ID:
            continue
        w = t.text
        if w in _ELIXIR_MOD_KW and k + 1 < n and toks[k + 1].kind == ID:
            chain = [toks[k + 1].text]
            j = k + 2
            while (
                j + 1 < n and toks[j].text == "." and toks[j + 1].kind == ID
            ):
                chain.append(toks[j + 1].text)
                j += 2
            # find this head's block `do`
            do_i = next(
                (
                    i2
                    for i2 in range(j, min(j + 8, n))
                    if toks[i2].kind == ID and toks[i2].text == "do"
                    and i2 in match_end
                ),
                None,
            )
            if do_i is not None:
                name = chain[-1]
                defs.append(
                    RawDef(".".join(chain), UnitType.CLASS, k, k + 1,
                           do_i, match_end[do_i], parent=parent)
                )
                class_stack.append((match_end[do_i], name))
            continue
        if w in _ELIXIR_DEF_KW and k + 1 < n and toks[k + 1].kind == ID:
            name = toks[k + 1].text
            j = k + 2
            if j < n and toks[j].kind == PUNCT and toks[j].text in "?!":
                name += toks[j].text
                j += 1
            params: List[str] = []
            if j < n and toks[j].text == "(":
                close = _match_bracket(toks, j, "(", ")")
                params = _params_from_slice(toks[j + 1 : close], "elixir")
                j = close + 1
            # Scan the rest of the head (guards) for the block `do` or the
            # keyword `, do:` one-liner.
            body_start = body_end = None
            for i2 in range(j, min(j + 40, n)):
                t2 = toks[i2]
                if t2.kind != ID:
                    continue
                if t2.text == "do":
                    # Keyword one-liner `do: expr` — same adjacent-colon
                    # rule as the block matcher above.
                    if _is_elixir_kw_do(toks, i2):
                        body_start = i2 + 2
                        body_end = _line_end_tok(toks, i2)
                        break
                    if i2 in match_end:
                        body_start = i2
                        body_end = match_end[i2]
                        break
                if t2.text in _ELIXIR_DEF_KW or t2.text in _ELIXIR_MOD_KW:
                    break  # next definition started; head had no body
            if body_end is None:
                continue
            defs.append(
                RawDef(
                    name,
                    UnitType.METHOD if parent else UnitType.FUNCTION,
                    k, k + 1, body_start, body_end,
                    parent=parent, params=params,
                )
            )
    return defs


_HASKELL_DECL_KW = frozenset(
    "data newtype type class instance module import foreign infixl infixr "
    "infix".split()
)


def _find_defs_decl(toks: List[Tok], language: str) -> List[RawDef]:
    """Haskell / OCaml: column-0 declaration grouping. A unit extends to
    the token before the next column-0 declaration; consecutive Haskell
    equations (and the type signature) of the same name form ONE unit."""
    n = len(toks)
    defs: List[RawDef] = []
    fol = _first_on_line_flags(toks)
    # Collect top-level decl start indices.
    starts = [
        k
        for k, t in enumerate(toks)
        if fol[k] and t.col == 0 and t.kind in (ID, PUNCT)
        and t.kind != COMMENT
    ]
    if language == "haskell":
        groups: List[Tuple[str, str, int, int]] = []  # name, kind, start, end
        for si, k in enumerate(starts):
            t = toks[k]
            nxt_start = starts[si + 1] if si + 1 < len(starts) else n
            end_tok = nxt_start - 1
            while end_tok > k and toks[end_tok].kind == COMMENT:
                end_tok -= 1
            if t.kind != ID:
                continue
            w = t.text
            if w in ("module", "import", "foreign", "infixl", "infixr",
                     "infix"):
                continue
            if w in ("data", "newtype", "type", "class"):
                if k + 1 < n and toks[k + 1].kind == ID:
                    groups.append((toks[k + 1].text, UnitType.CLASS, k,
                                   end_tok))
                continue
            if w == "instance":
                continue
            # Value binding: `name ::` or `name args... =`
            if groups and groups[-1][0] == w and groups[-1][1] == UnitType.FUNCTION:
                # Another equation of the same function: extend the group.
                name, kind, s0, _ = groups[-1]
                groups[-1] = (name, kind, s0, end_tok)
                continue
            seg = toks[k : min(k + 40, nxt_start)]
            has_sig = any(
                t2.kind == PUNCT and t2.text == "::" for t2 in seg
            )
            has_eq = any(t2.kind == PUNCT and t2.text == "=" for t2 in seg)
            if has_sig or has_eq:
                groups.append((w, UnitType.FUNCTION, k, end_tok))
        for name, kind, s0, e0 in groups:
            params: List[str] = []
            rtype = None
            if kind == UnitType.FUNCTION:
                # Params from the first EQUATION: IDs between the
                # line-leading name repetition and that line's `=` (the
                # type-signature line contributes the return type only).
                eq_starts = [
                    i2
                    for i2 in range(s0, e0 + 1)
                    if fol[i2] and toks[i2].kind == ID
                    and toks[i2].text == name
                    and not any(
                        toks[i3].kind == PUNCT and toks[i3].text == "::"
                        for i3 in range(i2, min(_line_end_tok(toks, i2) + 1,
                                                e0 + 1))
                    )
                ]
                if eq_starts:
                    e1 = eq_starts[0]
                    for k2 in range(e1, e0 + 1):
                        if toks[k2].kind == PUNCT and toks[k2].text == "=":
                            params = [
                                t2.text
                                for t2 in toks[e1 + 1 : k2]
                                if t2.kind == ID and t2.text != name
                            ][:8]
                            break
                for k2 in range(s0, e0):
                    if toks[k2].kind == PUNCT and toks[k2].text == "::":
                        # return type = last arrow segment of the signature
                        sig_end = next(
                            (
                                i2
                                for i2 in range(k2 + 1, e0 + 1)
                                if fol[i2] and toks[i2].col == 0
                            ),
                            e0 + 1,
                        )
                        arrows = [
                            i2
                            for i2 in range(k2, sig_end)
                            if toks[i2].kind == PUNCT
                            and toks[i2].text == "->"
                        ]
                        tail = arrows[-1] + 1 if arrows else k2 + 1
                        rtype = " ".join(
                            t2.text for t2 in toks[tail:sig_end]
                            if t2.kind != COMMENT
                        )[:60] or None
            defs.append(
                RawDef(name, kind, s0, s0, min(s0 + 1, e0), e0,
                       params=params, return_type=rtype)
            )
        return defs

    # --- OCaml ---
    module_stack: List[Tuple[int, str]] = []  # (end tok of struct, name)
    block_end_for: Dict[int, int] = {}
    ml_stack: List[int] = []
    for k, t in enumerate(toks):
        if t.kind != ID:
            continue
        if t.text in ("struct", "sig", "begin", "object"):
            ml_stack.append(k)
        elif t.text == "end":
            if ml_stack:
                block_end_for[ml_stack.pop()] = k
    top_kw = frozenset(
        "let type module class exception open and val external".split()
    )
    # A decl starts at a line-leading top keyword at column 0, or at the
    # MEMBER column of an enclosing `struct` body (the column of its first
    # line-leading decl). Deeper-indented `let ... in` bindings inside
    # function bodies are expression-local and must not split the unit.
    spans = sorted(
        (s, e) for s, e in block_end_for.items()
        if toks[s].text == "struct"
    )
    member_col: Dict[Tuple[int, int], int] = {}
    for s, e in spans:
        for k in range(s + 1, e):
            if toks[k].kind == ID and toks[k].text in top_kw and fol[k]:
                member_col[(s, e)] = toks[k].col
                break
    decl_idx = []
    for k, t in enumerate(toks):
        if t.kind != ID or t.text not in top_kw or not fol[k]:
            continue
        enclosing = [
            (s, e) for s, e in spans if s < k < e
        ]
        if enclosing:
            s, e = max(enclosing)  # innermost (latest start)
            if t.col == member_col.get((s, e), 0):
                decl_idx.append(k)
        elif t.col == 0:
            decl_idx.append(k)
    for di, k in enumerate(decl_idx):
        t = toks[k]
        nxt = decl_idx[di + 1] if di + 1 < len(decl_idx) else n
        end_tok = nxt - 1
        enclosing = [(s, e) for s, e in spans if s < k < e]
        if enclosing:
            # A struct member never extends past its struct's `end`.
            end_tok = min(end_tok, max(enclosing)[1] - 1)
        while end_tok > k and toks[end_tok].kind == COMMENT:
            end_tok -= 1
        w = t.text
        module_stack = [(e, nm) for (e, nm) in module_stack if k < e]
        parent = module_stack[-1][1] if module_stack else None
        if w == "module" and k + 1 < n and toks[k + 1].kind == ID:
            name = toks[k + 1].text
            # module Name = struct ... end
            s_i = next(
                (
                    i2
                    for i2 in range(k + 2, min(k + 8, n))
                    if toks[i2].kind == ID and toks[i2].text in ("struct", "sig")
                ),
                None,
            )
            if s_i is not None and s_i in block_end_for:
                defs.append(
                    RawDef(name, UnitType.CLASS, k, k + 1, s_i,
                           block_end_for[s_i], parent=parent)
                )
                module_stack.append((block_end_for[s_i], name))
            else:
                defs.append(
                    RawDef(name, UnitType.CLASS, k, k + 1,
                           min(k + 2, end_tok), end_tok, parent=parent)
                )
            continue
        if w in ("type", "exception", "class") and k + 1 < n:
            j = k + 1
            while j < n and toks[j].kind == ID and toks[j].text in (
                "rec", "nonrec", "virtual",
            ):
                j += 1
            if j < n and toks[j].kind == ID:
                defs.append(
                    RawDef(toks[j].text, UnitType.CLASS, k, j,
                           min(j + 1, end_tok), end_tok, parent=parent)
                )
            continue
        if w in ("let", "and", "val", "external") and k + 1 < n:
            j = k + 1
            if j < n and toks[j].kind == ID and toks[j].text == "rec":
                j += 1
            if j >= n or toks[j].kind != ID:
                continue
            name = toks[j].text
            if name == "_":
                continue
            params = []
            for k2 in range(j + 1, min(end_tok + 1, j + 30)):
                if toks[k2].kind == PUNCT and toks[k2].text == "=":
                    params = [
                        t2.text
                        for t2 in toks[j + 1 : k2]
                        if t2.kind == ID
                    ][:8]
                    break
            defs.append(
                RawDef(
                    name,
                    UnitType.METHOD if parent else UnitType.FUNCTION,
                    k, j, min(j + 1, end_tok), end_tok,
                    parent=parent, params=params,
                )
            )
    return defs


def _find_defs_r(toks: List[Tok]) -> List[RawDef]:
    """R: `name <- function(args) { ... }` (also `=` / `<<-`), S4
    setClass/setGeneric/setMethod("name", ...), R6Class assignments."""
    n = len(toks)
    defs: List[RawDef] = []
    for k, t in enumerate(toks):
        if t.kind != ID:
            continue
        # name <- function(...) { ... }
        if (
            t.text == "function"
            and k >= 2
            and toks[k - 1].kind == PUNCT
            and toks[k - 1].text in ("<-", "=", "<<-")
            and toks[k - 2].kind == ID
            and k + 1 < n
            and toks[k + 1].text == "("
        ):
            name = toks[k - 2].text
            close = _match_bracket(toks, k + 1, "(", ")")
            params = _params_from_slice(toks[k + 2 : close], "r")
            j = close + 1
            if j < n and toks[j].text == "{":
                end = _match_bracket(toks, j, "{", "}")
                defs.append(
                    RawDef(name, UnitType.FUNCTION, k - 2, k - 2, j, end,
                           params=params)
                )
            else:
                defs.append(
                    RawDef(name, UnitType.FUNCTION, k - 2, k - 2,
                           min(j, n - 1), _line_end_tok(toks, min(j, n - 1)),
                           params=params)
                )
            continue
        # setClass("Name", ...) / setGeneric("name", ...) / R6Class("Name"
        if (
            t.text in ("setClass", "setGeneric", "setMethod", "R6Class")
            and k + 2 < n
            and toks[k + 1].text == "("
            and toks[k + 2].kind == STR
        ):
            name = toks[k + 2].text.strip("\"'")
            close = _match_bracket(toks, k + 1, "(", ")")
            # R6Class: prefer the assignment target when present.
            if (
                t.text == "R6Class"
                and k >= 2
                and toks[k - 1].text in ("<-", "=", "<<-")
                and toks[k - 2].kind == ID
            ):
                name = toks[k - 2].text
            defs.append(
                RawDef(
                    name,
                    UnitType.CLASS
                    if t.text in ("setClass", "R6Class")
                    else UnitType.FUNCTION,
                    k, k, k + 1, close,
                )
            )
    return defs


_ZIG_CONTAINERS = frozenset(("struct", "enum", "union", "opaque"))


def _find_defs_zig(toks: List[Tok]) -> List[RawDef]:
    """Zig: `[pub] fn name(...) T { ... }`, `const Name = struct { ... };`,
    `test "name" { ... }` blocks; container members become methods."""
    n = len(toks)
    defs: List[RawDef] = []
    class_stack: List[Tuple[int, str]] = []
    k = 0
    while k < n:
        t = toks[k]
        while class_stack and k > class_stack[-1][0]:
            class_stack.pop()
        parent = class_stack[-1][1] if class_stack else None
        if t.kind != ID:
            k += 1
            continue
        w = t.text
        if w == "fn" and k + 1 < n and toks[k + 1].kind == ID:
            name = toks[k + 1].text
            j = k + 2
            params: List[str] = []
            rtype = None
            if j < n and toks[j].text == "(":
                close = _match_bracket(toks, j, "(", ")")
                params = [
                    toks[i2].text
                    for i2 in range(j + 1, close)
                    if toks[i2].kind == ID
                    and i2 + 1 < n
                    and toks[i2 + 1].text == ":"
                ][:15]
                j = close + 1
            rt0 = j
            while j < n and not (
                toks[j].kind == PUNCT and toks[j].text in "{;"
            ):
                j += 1
            if j > rt0:
                rtype = " ".join(
                    t2.text for t2 in toks[rt0:j] if t2.kind != COMMENT
                )[:60] or None
            di = k
            if k and toks[k - 1].kind == ID and toks[k - 1].text in (
                "pub", "export", "extern", "inline",
            ):
                di = k - 1
            if j < n and toks[j].text == "{":
                end = _match_bracket(toks, j, "{", "}")
                defs.append(
                    RawDef(
                        name,
                        UnitType.METHOD if parent else UnitType.FUNCTION,
                        di, k + 1, j, end,
                        parent=parent, params=params, return_type=rtype,
                    )
                )
                k = j + 1
                continue
            k = j + 1
            continue
        if (
            w in ("const", "var")
            and k + 3 < n
            and toks[k + 1].kind == ID
            and toks[k + 2].text == "="
        ):
            j = k + 3
            if (
                j < n
                and toks[j].kind == ID
                and toks[j].text in ("packed", "extern")
            ):
                j += 1
            if j < n and toks[j].kind == ID and toks[j].text in _ZIG_CONTAINERS:
                j2 = j + 1
                if j2 < n and toks[j2].text == "(":
                    j2 = _match_bracket(toks, j2, "(", ")") + 1
                if j2 < n and toks[j2].text == "{":
                    end = _match_bracket(toks, j2, "{", "}")
                    name = toks[k + 1].text
                    di = (
                        k - 1
                        if k and toks[k - 1].kind == ID
                        and toks[k - 1].text == "pub"
                        else k
                    )
                    defs.append(
                        RawDef(name, UnitType.CLASS, di, k + 1, j2, end,
                               parent=parent)
                    )
                    class_stack.append((end, name))
                    k = j2 + 1
                    continue
        if w == "test" and k + 1 < n and toks[k + 1].kind == STR:
            j = k + 2
            if j < n and toks[j].text == "{":
                end = _match_bracket(toks, j, "{", "}")
                defs.append(
                    RawDef(
                        toks[k + 1].text.strip('"'),
                        UnitType.FUNCTION, k, k + 1, j, end,
                    )
                )
                k = j + 1
                continue
        k += 1
    return defs


_SQL_OBJECTS = {
    "function": UnitType.FUNCTION,
    "procedure": UnitType.FUNCTION,
    "trigger": UnitType.FUNCTION,
    "table": UnitType.CLASS,
    "view": UnitType.CLASS,
    "type": UnitType.CLASS,
    "schema": UnitType.CLASS,
    "index": UnitType.CONSTANT,
    "sequence": UnitType.CONSTANT,
}
_SQL_MODIFIERS = frozenset(
    "or replace temp temporary materialized unique global local if not "
    "exists concurrently recursive definer".split()
)


def _find_defs_sql(toks: List[Tok]) -> List[RawDef]:
    """SQL DDL: CREATE [modifiers] {FUNCTION|PROCEDURE|TABLE|VIEW|TRIGGER|
    INDEX|TYPE|SCHEMA|SEQUENCE} name ... ; — case-insensitive; dollar-quoted
    bodies are single tokens so `;` inside plpgsql never ends a statement
    early."""
    n = len(toks)
    defs: List[RawDef] = []
    k = 0
    while k < n:
        t = toks[k]
        if t.kind != ID or t.text.lower() != "create":
            k += 1
            continue
        j = k + 1
        while j < n and toks[j].kind == ID and toks[j].text.lower() in _SQL_MODIFIERS:
            j += 1
        if j >= n or toks[j].kind != ID:
            k += 1
            continue
        obj = toks[j].text.lower()
        utype = _SQL_OBJECTS.get(obj)
        if utype is None:
            k = j + 1
            continue
        j += 1
        # Name: ID or quoted string; schema-qualified a.b.c keeps last part.
        name = None
        chain = []
        while j < n:
            t2 = toks[j]
            if t2.kind == ID:
                chain.append(t2.text)
                j += 1
                if j < n and toks[j].kind == PUNCT and toks[j].text == ".":
                    j += 1
                    continue
                break
            if t2.kind == STR:
                chain.append(t2.text.strip("\"'`"))
                j += 1
                if j < n and toks[j].kind == PUNCT and toks[j].text == ".":
                    j += 1
                    continue
                break
            break
        if chain:
            name = chain[-1]
        if not name:
            k = j
            continue
        # Statement extent: to `;` at paren depth 0 (or next CREATE / EOF).
        depth = 0
        end = n - 1
        for i2 in range(j, n):
            t2 = toks[i2]
            if t2.kind == PUNCT:
                if t2.text == "(":
                    depth += 1
                elif t2.text == ")":
                    depth = max(depth - 1, 0)
                elif t2.text == ";" and depth == 0:
                    end = i2
                    break
            elif (
                t2.kind == ID
                and t2.text.lower() == "create"
                and depth == 0
            ):
                end = i2 - 1
                break
        params: List[str] = []
        if utype == UnitType.FUNCTION and j < n and toks[j].text == "(":
            close = _match_bracket(toks, j, "(", ")")
            params = [
                t2.text
                for t2 in toks[j + 1 : close]
                if t2.kind == ID
                and t2.text.lower() not in (
                    "in", "out", "inout", "int", "integer", "text",
                    "varchar", "boolean", "bigint", "numeric", "timestamp",
                )
            ][:15]
        defs.append(
            RawDef(name, utype, k, j - 1, min(j, end), end, params=params)
        )
        k = end + 1
    return defs


def _find_defs_css(toks: List[Tok]) -> List[RawDef]:
    """CSS: every `selector { ... }` rule becomes a section-like unit named
    by its selector; @media/@supports blocks contribute their inner rules
    too (the outer at-rule is also emitted)."""
    n = len(toks)
    defs: List[RawDef] = []

    def walk(start: int, end: int, parent: Optional[str]):
        sel_start = start
        k = start
        while k < end:
            t = toks[k]
            if t.kind == COMMENT:
                if sel_start == k:
                    sel_start = k + 1
                k += 1
                continue
            if t.kind == PUNCT and t.text == ";":
                sel_start = k + 1
                k += 1
                continue
            if t.kind == PUNCT and t.text == "{":
                sel_toks = [
                    t2 for t2 in toks[sel_start:k] if t2.kind != COMMENT
                ]
                close = _match_bracket(toks, k, "{", "}")
                name = "".join(
                    (t2.text if t2.kind != STR else t2.text)
                    + (" " if t2.kind == ID and t2.text[-1:].isalnum() else "")
                    for t2 in sel_toks
                ).strip()[:80]
                if name:
                    defs.append(
                        RawDef(
                            name, UnitType.SECTION,
                            sel_start if sel_toks else k,
                            sel_start if sel_toks else k,
                            k, close, parent=parent,
                        )
                    )
                    if name.startswith("@"):
                        walk(k + 1, close, name)
                sel_start = close + 1
                k = close + 1
                continue
            k += 1

    walk(0, n, None)
    return defs


def _find_defs_qml(toks: List[Tok]) -> List[RawDef]:
    """QML: capitalized `Component { ... }` object declarations plus
    embedded JavaScript `function name(...) { ... }` members and
    `signal name(...)` declarations."""
    n = len(toks)
    defs: List[RawDef] = []
    obj_stack: List[Tuple[int, str]] = []
    k = 0
    while k < n:
        t = toks[k]
        while obj_stack and k > obj_stack[-1][0]:
            obj_stack.pop()
        parent = obj_stack[-1][1] if obj_stack else None
        if t.kind != ID:
            k += 1
            continue
        w = t.text
        if w == "function" and k + 1 < n and toks[k + 1].kind == ID:
            name = toks[k + 1].text
            j = k + 2
            params: List[str] = []
            if j < n and toks[j].text == "(":
                close = _match_bracket(toks, j, "(", ")")
                params = _params_from_slice(toks[j + 1 : close], "javascript")
                j = close + 1
            while j < n and not (
                toks[j].kind == PUNCT and toks[j].text in "{;"
            ):
                j += 1
            if j < n and toks[j].text == "{":
                end = _match_bracket(toks, j, "{", "}")
                defs.append(
                    RawDef(name, UnitType.METHOD if parent else
                           UnitType.FUNCTION, k, k + 1, j, end,
                           parent=parent, params=params)
                )
                k = j + 1
                continue
        if w == "signal" and k + 1 < n and toks[k + 1].kind == ID:
            name = toks[k + 1].text
            le = _line_end_tok(toks, k)
            defs.append(
                RawDef(name, UnitType.FUNCTION, k, k + 1,
                       min(k + 2, le), le, parent=parent)
            )
            k = le + 1
            continue
        if (
            w[0:1].isupper()
            and k + 1 < n
            and toks[k + 1].kind == PUNCT
            and toks[k + 1].text == "{"
            # property assignment `Foo {` only at declaration position:
            # previous token is not `:` / `=` (those are bindings).
            and (k == 0 or toks[k - 1].text not in (":", "=", "(", ","))
        ):
            end = _match_bracket(toks, k + 1, "{", "}")
            defs.append(
                RawDef(w, UnitType.CLASS, k, k, k + 1, end, parent=parent)
            )
            obj_stack.append((end, w))
            k += 2
            continue
        k += 1
    return defs


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

_IMPORT_HEAD = {
    "javascript": ("import", "require"),
    "typescript": ("import", "require"),
    "go": ("import",),
    "rust": ("use",),
    "java": ("import",),
    "csharp": ("using",),
    "c": (),
    "cpp": (),
    "ruby": ("require", "require_relative"),
    "kotlin": ("import",),
    "swift": ("import",),
    "scala": ("import",),
    "php": ("use", "require", "require_once", "include"),
    "lua": ("require", "dofile"),
    "julia": ("using", "import", "include"),
    "elixir": ("import", "alias", "use", "require"),
    "r": ("library", "require", "source"),
    "zig": ("import",),  # @import("std"): `@` lexes as punct, `import` hits
    "haskell": ("import",),
    "ocaml": ("open",),
    "sql": (),
    "css": (),
    "qml": ("import",),
}


def _imports(toks: Sequence[Tok], language: str, content: str) -> List[str]:
    if language in ("c", "cpp"):
        mods = re.findall(r'^\s*#\s*include\s+[<"]([^>"]+)', content, re.M)
        return list(dict.fromkeys(m.split("/")[0].split(".")[0] for m in mods))[:20]
    heads = _IMPORT_HEAD.get(language, ())
    out: List[str] = []

    def add_str(t2):
        mod = t2.text.strip("\"'`").split("/")[0]
        if mod and mod not in out:
            out.append(mod)

    for k, t in enumerate(toks[:600]):
        if t.kind == ID and t.text in heads:
            if (
                language == "go"
                and k + 1 < len(toks)
                and toks[k + 1].text == "("
            ):
                # Grouped form: import ( "a" alias "b" ... )
                for t2 in toks[k + 2 :]:
                    if t2.kind == PUNCT and t2.text == ")":
                        break
                    if t2.kind == STR:
                        add_str(t2)
                continue
            for t2 in toks[k + 1 : k + 12]:
                if t2.kind == STR:
                    add_str(t2)
                    break
                if t2.kind == ID and language in (
                    "rust", "java", "csharp", "go", "kotlin", "swift",
                    "scala", "php", "julia", "elixir", "r", "haskell",
                    "ocaml", "qml",
                ):
                    if t2.text not in out and t2.text not in ("static",):
                        out.append(t2.text)
                    break
    return out[:20]


def parse_structured(
    path: str, content: str, language: str
) -> Optional[Tuple[List[CodeUnit], List[bool]]]:
    """Full structural extraction. Returns (units, covered-lines mask) — the
    caller turns uncovered regions into RawCode chunks — or None when
    `language` is unsupported (falls back to the regex layer)."""
    if language not in SUPPORTED:
        return None
    toks = tokenize(content, language)
    if not toks:
        return [], []
    defs = _find_defs(toks, language)
    lines = content.splitlines()
    if language == "css":
        # Selector names come from the source text (token-joining mangles
        # `#header h1, .brand` and `@media (max-width: 600px)`).
        for d in defs:
            t0, t1 = toks[d.name_idx], toks[d.body_start]
            if (t0.line, t0.col) <= (t1.line, t1.col):
                if t0.line == t1.line:
                    txt = lines[t0.line - 1][t0.col : t1.col]
                else:
                    txt = " ".join(
                        [lines[t0.line - 1][t0.col :]]
                        + lines[t0.line : t1.line - 1]
                        + [lines[t1.line - 1][: t1.col]]
                    )
                txt = re.sub(r"\s+", " ", txt).strip().rstrip("{").strip()
                if txt:
                    d.name = txt[:80]
        for d in defs:
            if d.parent is not None:
                outer = next(
                    (
                        o
                        for o in defs
                        if o is not d
                        and o.body_start < d.name_idx <= o.body_end
                    ),
                    None,
                )
                d.parent = outer.name if outer else None
    imports = _imports(toks, language, content)
    units: List[CodeUnit] = []
    covered = [False] * len(lines)
    for d in defs:
        head_line = toks[d.def_idx].line
        end_line = toks[d.body_end].line + toks[d.body_end].text.count("\n")
        body_toks = [
            t
            for t in toks[d.body_start : d.body_end + 1]
            if t.kind in (ID, PUNCT)
        ]
        calls, comp, loops, branches, errors, variables = _analyze(
            body_toks, d.name, language
        )
        signature = " ".join(
            ln.strip()
            for ln in lines[head_line - 1 : min(toks[d.body_start].line, head_line + 2)]
        )
        signature = signature.split("{")[0].strip()[:200]
        qualified = f"{d.parent}.{d.name}" if d.parent else d.name
        units.append(
            CodeUnit(
                name=d.name,
                qualified_name=qualified,
                file=path,
                line=head_line,
                end_line=min(end_line, len(lines)),
                language=language,
                unit_type=d.unit_type,
                signature=signature,
                docstring=_docstring(toks, d.def_idx, head_line),
                parameters=d.params or [],
                return_type=d.return_type,
                parent_class=d.parent if d.unit_type == UnitType.METHOD else None,
                extends=d.extends,
                calls=calls,
                complexity=comp,
                has_loops=loops,
                has_branches=branches,
                has_error_handling=errors,
                variables=variables,
                imports=imports,
                code="\n".join(lines[head_line - 1 : min(end_line, len(lines))]),
            )
        )
        for ln in range(head_line - 1, min(end_line, len(lines))):
            covered[ln] = True
    return units, covered
