"""Code-unit model for semantic code search.

Mirrors the reference's `CodeUnit`
(colgrep/src/parser/types.rs:117-153): identity + the 5
analysis layers (AST, call graph, control flow, data flow, dependencies)
plus the raw source. Language detection is extension-based
(types.rs:7-100)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


class UnitType:
    FUNCTION = "function"
    METHOD = "method"
    CLASS = "class"
    CONSTANT = "constant"
    DOCUMENT = "document"
    SECTION = "section"
    RAW_CODE = "rawcode"


# Definition-bearing unit kinds (synthetic names excluded from boosts).
DEFINITION_TYPES = frozenset(
    {UnitType.FUNCTION, UnitType.METHOD, UnitType.CLASS, UnitType.CONSTANT}
)

# extension -> language id. Covers the reference's grammars plus text formats.
EXTENSION_LANGUAGES: Dict[str, str] = {
    ".py": "python", ".pyi": "python",
    ".js": "javascript", ".jsx": "javascript", ".mjs": "javascript",
    ".cjs": "javascript",
    ".ts": "typescript", ".tsx": "typescript", ".mts": "typescript",
    ".go": "go",
    ".rs": "rust",
    ".java": "java",
    ".kt": "kotlin", ".kts": "kotlin",
    ".c": "c", ".h": "c",
    ".cpp": "cpp", ".cc": "cpp", ".cxx": "cpp", ".hpp": "cpp", ".hh": "cpp",
    ".cs": "csharp",
    ".rb": "ruby",
    ".php": "php",
    ".swift": "swift",
    ".scala": "scala",
    ".lua": "lua",
    ".ex": "elixir", ".exs": "elixir",
    ".hs": "haskell",
    ".ml": "ocaml", ".mli": "ocaml",
    ".r": "r", ".R": "r",
    ".zig": "zig",
    ".jl": "julia",
    ".dart": "dart",
    ".vue": "vue",
    ".svelte": "svelte",
    ".qml": "qml",
    ".sh": "shell", ".bash": "shell", ".zsh": "shell",
    ".ps1": "powershell",
    ".sql": "sql",
    ".html": "html", ".htm": "html",
    ".css": "css",
    ".md": "markdown", ".markdown": "markdown",
    ".rst": "text", ".adoc": "text", ".org": "text", ".txt": "text",
    ".yaml": "yaml", ".yml": "yaml",
    ".toml": "toml",
    ".json": "json",
}

SPECIAL_FILENAMES: Dict[str, str] = {
    "dockerfile": "dockerfile",
    "makefile": "makefile",
    "cmakelists.txt": "cmake",
}


def detect_language(path) -> Optional[str]:
    p = Path(path)
    special = SPECIAL_FILENAMES.get(p.name.lower())
    if special:
        return special
    return EXTENSION_LANGUAGES.get(p.suffix if p.suffix != ".R" else ".R")


@dataclass
class CodeUnit:
    # identity
    name: str
    qualified_name: str
    file: str
    line: int
    end_line: int
    language: str
    unit_type: str
    # layer 1: AST
    signature: str = ""
    docstring: Optional[str] = None
    parameters: List[str] = field(default_factory=list)
    return_type: Optional[str] = None
    extends: Optional[str] = None
    parent_class: Optional[str] = None
    # layer 2: call graph
    calls: List[str] = field(default_factory=list)
    called_by: List[str] = field(default_factory=list)
    # layer 3: control flow
    complexity: int = 1
    has_loops: bool = False
    has_branches: bool = False
    has_error_handling: bool = False
    # layer 4: data flow
    variables: List[str] = field(default_factory=list)
    # layer 5: dependencies
    imports: List[str] = field(default_factory=list)
    # source
    code: str = ""

    def to_metadata(self) -> Dict[str, Any]:
        """Row for the index metadata.db (thin columns are filterable;
        `code`/`signature` land in METADATA_CONTENT — filtering.rs THIN_COLUMNS)."""
        return {
            "file": self.file,
            "name": self.name,
            "qualified_name": self.qualified_name,
            "line": self.line,
            "end_line": self.end_line,
            "language": self.language,
            "unit_type": self.unit_type,
            "complexity": self.complexity,
            "has_loops": self.has_loops,
            "has_branches": self.has_branches,
            "has_error_handling": self.has_error_handling,
            "signature": self.signature,
            "docstring": self.docstring or "",
            "code": self.code,
        }

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
