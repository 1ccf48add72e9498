"""Single-file-component / markup parsing: Vue, Svelte, HTML.

The reference ships dedicated special-format parsers for these
(colgrep/src/parser/ vue/svelte/html modules, types.rs:57-97). Here the
same behavior is composed from the structural parser: `<script>` blocks are
cut out and parsed as JavaScript/TypeScript (lang attr respected) with all
line numbers mapped back into the host file, `<style>` blocks parse as CSS,
and the remaining markup becomes one component/document unit so templates
stay searchable.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

from nextplaid_tpu_torch.codesearch.types import CodeUnit, UnitType

_SCRIPT_RE = re.compile(
    r"<script\b(?P<attrs>[^>]*)>(?P<body>.*?)</script\s*>",
    re.I | re.S,
)
_STYLE_RE = re.compile(
    r"<style\b[^>]*>(?P<body>.*?)</style\s*>", re.I | re.S
)
_LANG_RE = re.compile(r"""lang\s*=\s*["']?(?P<lang>[\w-]+)""", re.I)
_TEMPLATE_RE = re.compile(
    r"<template\b[^>]*>(?P<body>.*)</template\s*>", re.I | re.S
)
_TITLE_RE = re.compile(r"<title[^>]*>(?P<t>[^<]*)</title>", re.I)
_ID_ATTR_RE = re.compile(r"""\bid\s*=\s*["'](?P<id>[\w:.-]+)["']""")

WEB_LANGUAGES = frozenset(("vue", "svelte", "html"))


def _script_lang(attrs: str) -> str:
    m = _LANG_RE.search(attrs)
    if m and m.group("lang").lower() in ("ts", "typescript"):
        return "typescript"
    return "javascript"


def _shift(units: List[CodeUnit], offset_lines: int) -> List[CodeUnit]:
    for u in units:
        u.line += offset_lines
        u.end_line += offset_lines
    return units


def parse_web(
    path: str, content: str, language: str
) -> Optional[Tuple[List[CodeUnit], List[bool]]]:
    """Extract units from a Vue/Svelte/HTML file. Returns (units, covered)
    like structparse.parse_structured, or None for other languages."""
    if language not in WEB_LANGUAGES:
        return None
    from nextplaid_tpu_torch.codesearch.structparse import parse_structured

    lines = content.splitlines()
    covered = [False] * len(lines)
    units: List[CodeUnit] = []

    def sub_parse(body: str, start_pos: int, sub_lang: str):
        offset = content.count("\n", 0, start_pos)
        sub = parse_structured(path, body, sub_lang)
        if sub is None:
            return
        sub_units, sub_covered = sub
        units.extend(_shift(sub_units, offset))
        for i, c in enumerate(sub_covered):
            if c and offset + i < len(covered):
                covered[offset + i] = True

    for m in _SCRIPT_RE.finditer(content):
        sub_parse(
            m.group("body"),
            m.start("body"),
            _script_lang(m.group("attrs")),
        )
    for m in _STYLE_RE.finditer(content):
        sub_parse(m.group("body"), m.start("body"), "css")

    # One component/document unit for the markup itself.
    name = None
    if language == "html":
        t = _TITLE_RE.search(content)
        if t and t.group("t").strip():
            name = t.group("t").strip()[:80]
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    tmpl = _TEMPLATE_RE.search(content) if language == "vue" else None
    markup = tmpl.group("body") if tmpl else content
    ids = list(dict.fromkeys(_ID_ATTR_RE.findall(markup)))[:15]
    first_line = (
        content.count("\n", 0, tmpl.start()) + 1 if tmpl else 1
    )
    last_line = (
        content.count("\n", 0, tmpl.end()) + 1 if tmpl else len(lines)
    )
    units.append(
        CodeUnit(
            name=name,
            qualified_name=name,
            file=path,
            line=first_line,
            end_line=max(last_line, first_line),
            language=language,
            unit_type=UnitType.DOCUMENT,
            signature=f"<{language}> {name}",
            docstring=None,
            variables=ids,
            code="\n".join(lines[first_line - 1 : last_line])[:8192],
        )
    )
    for ln in range(first_line - 1, min(last_line, len(lines))):
        covered[ln] = True
    return units, covered
