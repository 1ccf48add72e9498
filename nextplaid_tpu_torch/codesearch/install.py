"""Agent integration installers.

Reference: colgrep/src/install/*.rs — installs a Claude Code plugin (skill +
hooks that steer Grep/Glob toward semantic search), plus OpenCode/Codex
variants. Here: writes a project-level skill file and prints the hook JSON
for the user's settings; nothing outside the target project is touched.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

SKILL_TEMPLATE = """---
name: cgrep
description: Semantic code search over this repository (ColBERT late-interaction + BM25 hybrid). Use instead of plain grep when searching by meaning, concept, or natural-language description rather than exact strings.
---

# cgrep — semantic code search

Search this repository by meaning:

```bash
{cgrep_cmd} "where is the retry logic" --path {project}
{cgrep_cmd} "function that validates auth tokens" --json --path {project}
{cgrep_cmd} -e "fn\\s+retry" "retry wrapper" --path {project}   # + regex filter
```

- Results are ranked by hybrid semantic+BM25 score with path/definition
  boosts; one hit per file.
- `--include/--exclude/--exclude-dir` filter paths; `-e REGEX` restricts to
  units whose code matches.
- The index updates incrementally on each search (`--no-update` to skip).
"""

HOOK_SNIPPET = {
    "hooks": {
        "PreToolUse": [
            {
                "matcher": "Grep",
                "hooks": [
                    {
                        "type": "command",
                        "command": (
                            "echo 'Consider cgrep for semantic/NL queries: "
                            "cgrep \"<your query>\"' >&2; exit 0"
                        ),
                    }
                ],
            }
        ]
    }
}


def install_claude_code(project: str, cgrep_cmd: str = "python -m nextplaid_tpu_torch.codesearch.cli") -> Path:
    """Write the skill file into PROJECT/.claude/skills/cgrep/SKILL.md and
    return its path. The hook snippet is returned for manual merging (we
    never edit the user's settings.json)."""
    root = Path(project).resolve()
    skill_dir = root / ".claude" / "skills" / "cgrep"
    skill_dir.mkdir(parents=True, exist_ok=True)
    skill = skill_dir / "SKILL.md"
    skill.write_text(
        SKILL_TEMPLATE.format(cgrep_cmd=cgrep_cmd, project=root)
    )
    return skill


def hook_snippet_json() -> str:
    return json.dumps(HOOK_SNIPPET, indent=2)


# ---------------------------------------------------------------------------
# AGENTS.md-based installers (reference colgrep/src/install/{opencode,codex,
# hermes}.rs): append a marker-delimited cgrep section to the agent's
# user-level AGENTS.md, idempotently; uninstall removes exactly that section.
# ---------------------------------------------------------------------------

MARKER_BEGIN = "<!-- cgrep:begin -->"
MARKER_END = "<!-- cgrep:end -->"

AGENTS_SECTION = """{begin}
## cgrep — semantic code search

This machine has `cgrep`, a semantic code-search CLI (ColBERT
late-interaction + BM25 hybrid). Prefer it over plain grep when searching
by meaning, concept, or natural-language description:

```bash
{cgrep_cmd} "where is the retry logic" --path <project>
{cgrep_cmd} "function that validates auth tokens" --json --path <project>
{cgrep_cmd} -e "def\\s+retry" "retry wrapper" --path <project>
```

Plain-string / exact-regex lookups are still faster with grep/rg.
{end}"""


def _agent_dir(agent: str, base: Path | None = None) -> Path:
    home = base or Path(os.environ.get("CGREP_AGENT_HOME", Path.home()))
    return {
        "opencode": home / ".config" / "opencode",
        "codex": home / ".codex",
        "hermes": home / ".hermes",
    }[agent]


def install_agents_md(
    agent: str,
    cgrep_cmd: str = "cgrep",
    base: Path | None = None,
) -> Path:
    """Idempotently add (or refresh) the cgrep section in the agent's
    user-level AGENTS.md; returns the file path."""
    path = _agent_dir(agent, base) / "AGENTS.md"
    path.parent.mkdir(parents=True, exist_ok=True)
    section = AGENTS_SECTION.format(
        begin=MARKER_BEGIN, end=MARKER_END, cgrep_cmd=cgrep_cmd
    )
    content = path.read_text() if path.exists() else ""
    cleaned = _strip_section(content)
    new = (cleaned.rstrip() + "\n\n" if cleaned.strip() else "") + section + "\n"
    path.write_text(new)
    return path


def uninstall_agents_md(agent: str, base: Path | None = None) -> bool:
    """Remove the cgrep section; deletes the file if nothing else remains.
    Returns True if anything changed."""
    path = _agent_dir(agent, base) / "AGENTS.md"
    if not path.exists():
        return False
    content = path.read_text()
    if MARKER_BEGIN not in content:
        return False
    cleaned = _strip_section(content)
    if cleaned.strip():
        path.write_text(cleaned.rstrip() + "\n")
    else:
        path.unlink()
    return True


def _strip_section(content: str) -> str:
    while MARKER_BEGIN in content:
        lo = content.index(MARKER_BEGIN)
        # Search END strictly after BEGIN: a stray END before BEGIN (hand-
        # edited file) must not produce hi < lo, which would duplicate the
        # overlap and loop forever.
        hi = content.find(MARKER_END, lo)
        if hi < 0:
            # Unterminated section: drop from BEGIN to end of file.
            return content[:lo]
        content = content[:lo] + content[hi + len(MARKER_END):]
    return content
