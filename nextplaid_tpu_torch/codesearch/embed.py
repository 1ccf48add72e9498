"""Structured embedding-text representation of code units.

Behavioral rebuild of the reference's embed module
(colgrep/src/embed.rs): a "Function:/Signature:/Description:/
Parameters:/Calls:/Variables:/Uses:/File:/Code:" layout with an 8 KB char cap
and truncation marker, plus path normalization (camelCase/snake split,
shortened to filename + 3 parent folders)."""

from __future__ import annotations

from pathlib import PurePosixPath

from nextplaid_tpu_torch.codesearch.types import CodeUnit, UnitType

MAX_EMBEDDING_TEXT_CHARS = 8 * 1024
TRUNCATION_MARKER = "\n[...truncated...]\n"

_TYPE_LABELS = {
    UnitType.FUNCTION: "Function",
    UnitType.METHOD: "Method",
    UnitType.CLASS: "Class",
    UnitType.CONSTANT: "Constant",
    UnitType.DOCUMENT: "Document",
    UnitType.SECTION: "Section",
    UnitType.RAW_CODE: "Code block",
}


def shorten_path(path: str) -> str:
    """Filename plus up to 3 parent folders (embed.rs:14-23)."""
    parts = PurePosixPath(path.replace("\\", "/")).parts
    return str(PurePosixPath(*parts[max(len(parts) - 4, 0):]))


def normalize_path_for_embedding(path_str: str) -> str:
    """Separator/underscore/hyphen/dot -> spaces, camelCase split, lowered,
    original filename appended (embed.rs:26-83)."""
    original_filename = path_str.replace("\\", "/").rsplit("/", 1)[-1]
    dot = path_str.rfind(".")
    body = path_str[:dot] if dot >= 0 else path_str
    out = []
    prev = ""
    for i, c in enumerate(body):
        if c in "/\\":
            if out and out[-1] != " ":
                out.append(" ")
        elif c in "_-.":
            if not out or out[-1] != " ":
                out.append(" ")
        elif c.isupper():
            if i > 0 and body[i - 1].islower():
                out.append(" ")
            out.append(c)
        else:
            out.append(c)
        prev = c
    normalized = " ".join("".join(out).split()).lower()
    return f"{normalized} {original_filename}"


def truncate_text(text: str, max_chars: int = MAX_EMBEDDING_TEXT_CHARS) -> str:
    if len(text) <= max_chars:
        return text
    marker_len = len(TRUNCATION_MARKER)
    if max_chars <= marker_len:
        return TRUNCATION_MARKER[:max_chars]
    return text[: max_chars - marker_len].rstrip() + TRUNCATION_MARKER


def build_embedding_text(unit: CodeUnit) -> str:
    """5-layer structured text (embed.rs:115-210). RawCode/Constant units are
    just their raw code."""
    if unit.unit_type in (UnitType.RAW_CODE, UnitType.CONSTANT):
        return truncate_text(unit.code)

    parts = [f"{_TYPE_LABELS.get(unit.unit_type, 'Code block')}: {unit.name}"]
    if unit.signature:
        parts.append(f"Signature: {unit.signature}")
    if unit.extends:
        parts.append(f"Extends: {unit.extends}")
    if unit.parent_class:
        parts.append(f"Class: {unit.parent_class}")
    if unit.docstring:
        parts.append(f"Description: {unit.docstring}")
    if unit.parameters:
        parts.append(f"Parameters: {', '.join(unit.parameters)}")
    if unit.return_type:
        parts.append(f"Returns: {unit.return_type}")
    if unit.calls:
        parts.append(f"Calls: {', '.join(unit.calls)}")
    if unit.called_by:
        parts.append(f"Called by: {', '.join(unit.called_by)}")
    if unit.variables:
        parts.append(f"Variables: {', '.join(unit.variables)}")
    if unit.imports:
        parts.append(f"Uses: {', '.join(unit.imports)}")
    # File path before code so truncation keeps it (embed.rs:193-199).
    parts.append(
        f"File: {normalize_path_for_embedding(shorten_path(unit.file))}"
    )
    if unit.code:
        parts.append(f"Code:\n{unit.code}")
    return truncate_text("\n".join(parts))
