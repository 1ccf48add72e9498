"""Terminal result display with syntax highlighting.

Reference: colgrep/src/display.rs (syntect there, pygments here). Plain
fallback when stdout is not a TTY or pygments lexing fails."""

from __future__ import annotations

import sys
from typing import List

import click


def highlight_code(code: str, language: str) -> str:
    try:
        from pygments import highlight
        from pygments.formatters import TerminalFormatter
        from pygments.lexers import TextLexer, get_lexer_by_name

        try:
            lexer = get_lexer_by_name(language)
        except Exception:
            lexer = TextLexer()
        return highlight(code, lexer, TerminalFormatter()).rstrip("\n")
    except Exception:
        return code


def print_hits(
    hits: List,
    line_numbers: bool = True,
    context_lines: int = 6,
    color: bool = None,
) -> None:
    """Pretty-print SearchHit results (searcher.py) with highlighted code."""
    if color is None:
        color = sys.stdout.isatty()
    for h in hits:
        loc = f"{h.file}:{h.line}" if line_numbers else h.file
        click.secho(loc, fg="cyan", bold=True, nl=False, color=color)
        click.secho(
            f"  {h.unit_type} {h.name}", fg="green", nl=False, color=color
        )
        click.echo(f"  (score {h.score:.3f})")
        if h.signature:
            click.secho(f"  {h.signature}", fg="yellow", color=color)
        if h.docstring:
            first = h.docstring.strip().splitlines()[0]
            click.secho(f"  {first}", dim=True, color=color)
        body = h.code.strip()
        if body:
            snippet = "\n".join(body.splitlines()[:context_lines])
            rendered = (
                highlight_code(snippet, h.language) if color else snippet
            )
            for ln in rendered.splitlines():
                click.echo(f"  | {ln}")
        click.echo()
