"""`cgrep` — semantic code search CLI (reference: colgrep/src/{cli,main}.rs).

Default action is search; subcommands: init, status, clear, stats.
Grep-compatible flags: -e/--regexp, -i, -l, -c, -n, --include, --exclude,
--exclude-dir, --json, --no-rank-boosts, --path.

Model resolution: --model DIR or CGREP_MODEL env; without a model a
keyword-only (FTS5) search still works via --keyword.

The index and the encoder run on --device (default cuda; without a card the
command fails unless given --device cpu). Run it as
`python -m nextplaid_tpu_torch.codesearch.cli`.
"""

from __future__ import annotations

import json as jsonlib
import os

import click

from nextplaid_tpu_torch.codesearch.config import CgrepConfig
from nextplaid_tpu_torch.codesearch.indexer import ProjectIndexer
from nextplaid_tpu_torch.codesearch.searcher import Searcher, SearchOptions


def _load_encoder(
    model: str | None, batch_size: int | None = None, device: str | None = None
):
    """Model resolution order (reference commands/search.rs): --model flag,
    CGREP_MODEL env, then the persisted config's default_model. The encoder
    runs on `device` ("cuda" when None)."""
    cfg = CgrepConfig.load()
    model = model or os.environ.get("CGREP_MODEL") or cfg.default_model
    if not model:
        return None
    from nextplaid_tpu_torch.encoder import Colbert

    return Colbert(
        model, batch_size=batch_size or cfg.batch_size or 16, device=device
    )


def _indexer(project, model, index_dir=None, device=None) -> ProjectIndexer:
    encoder = _load_encoder(model, device=device)
    if encoder is None:
        raise click.ClickException(
            "No encoder model: pass --model DIR or set CGREP_MODEL"
        )
    return ProjectIndexer(project, encoder, index_dir=index_dir, device=device)


def _print_hits(hits, json_out, files_only, count_only, line_numbers):
    if json_out:
        click.echo(
            jsonlib.dumps(
                [
                    {
                        "file": h.file,
                        "name": h.name,
                        "unit_type": h.unit_type,
                        "line": h.line,
                        "end_line": h.end_line,
                        "score": round(h.score, 4),
                        "signature": h.signature,
                        "language": h.language,
                    }
                    for h in hits
                ],
                indent=2,
            )
        )
        return
    if count_only:
        click.echo(str(len(hits)))
        return
    if files_only:
        for h in hits:
            click.echo(h.file)
        return
    from nextplaid_tpu_torch.codesearch.display import print_hits

    print_hits(hits, line_numbers=line_numbers)


class _CgrepGroup(click.Group):
    """Group whose optional QUERY argument would otherwise swallow the
    subcommand token (`cgrep settings --set k v` parsed QUERY="settings" and
    then died on --set). When the FIRST token names a subcommand, shim an
    empty QUERY so click resolves the subcommand and its own options.

    Single-word queries that collide with a command name are therefore
    RESERVED (matching the reference CLI, where clap resolves subcommands
    first): `cgrep update` self-updates, it does not search. The escape
    hatch is the end-of-options marker — `cgrep -- update` searches for the
    literal word. Multi-word queries are never shadowed (`cgrep "update
    logic"` searches)."""

    def parse_args(self, ctx, args):
        if "--" in args:
            # Explicit end-of-options marker ANYWHERE (e.g. `cgrep --json
            # -- update`, not just as the first token): the query after it
            # is literal — suppress the command-name re-dispatch in cli()
            # below.
            ctx.meta["cgrep_literal_query"] = True
        if args and args[0] in self.commands:
            args = ["", *args]
        return super().parse_args(ctx, args)


@click.group(cls=_CgrepGroup, invoke_without_command=True)
@click.argument("query", required=False)
@click.option("--path", "path_", default=".", help="project root")
@click.option("--model", default=None, envvar="CGREP_MODEL")
@click.option("--index-dir", default=None)
@click.option("--top-k", "-k", type=int, default=None)
@click.option("--session-hook", is_flag=True,
              help="print agent session-start context and exit")
@click.option("-e", "--regexp", default=None, help="filter by code regex")
@click.option("-E", "--extended-regexp", is_flag=True,
              help="grep compatibility: -e patterns are already extended "
              "(Python re) syntax, so this flag is accepted and inert")
@click.option("-F", "--fixed-strings", is_flag=True,
              help="treat -e PATTERN as a literal string")
@click.option("-w", "--word-regexp", is_flag=True,
              help="match -e PATTERN only at word boundaries")
@click.option("-i", "--ignore-case", is_flag=True, default=False)
@click.option("-l", "--files-with-matches", "files_only", is_flag=True)
@click.option("-c", "--count", "count_only", is_flag=True)
@click.option("-n", "--line-number", "line_numbers", is_flag=True, default=True)
@click.option("--include", "includes", multiple=True)
@click.option("--exclude", "excludes", multiple=True)
@click.option("--exclude-dir", "exclude_dirs", multiple=True)
@click.option("--json", "json_out", is_flag=True)
@click.option("--no-rank-boosts", is_flag=True)
@click.option("--no-update", is_flag=True, help="skip auto index update")
@click.option("--device", default=None,
              help="torch device of the index and the encoder (default cuda, "
              "which needs a card; cpu runs without one)")
@click.pass_context
def cli(ctx, query, path_, model, index_dir, top_k, session_hook, regexp,
        extended_regexp, fixed_strings, word_regexp, ignore_case, files_only,
        count_only, line_numbers, includes, excludes, exclude_dirs, json_out,
        no_rank_boosts, no_update, device):
    """Semantic code search. QUERY searches; subcommands manage the index.

    Single words naming a subcommand are reserved for that subcommand;
    search for them literally with `cgrep -- WORD`.
    """
    del extended_regexp  # grep-compat no-op: -e is extended syntax already
    ctx.ensure_object(dict)
    ctx.obj.update(path=path_, model=model, index_dir=index_dir, device=device)
    if ctx.invoked_subcommand is not None:
        return
    if session_hook:
        _session_hook(path_, model, index_dir, device)
        return
    # The optional QUERY argument consumes the first bare token before click
    # resolves subcommands; re-dispatch when it names one (colgrep's
    # default-search-plus-subcommands UX) — unless the user passed `--`
    # (end of options), which forces a literal search.
    if query in cli.commands and not ctx.meta.get("cgrep_literal_query"):
        ctx.invoke(cli.commands[query])
        return
    if not query:
        click.echo(ctx.get_help())
        return
    if top_k is None:
        top_k = CgrepConfig.load().default_k or 10
    if regexp is not None:
        import re as _re

        if fixed_strings:
            regexp = _re.escape(regexp)
        if word_regexp:
            regexp = rf"\b(?:{regexp})\b"
    indexer = _indexer(path_, model, index_dir, device)
    if not no_update:
        indexer.update()
    searcher = Searcher(str(indexer.index_dir), indexer.encoder, device=indexer.device)
    opts = SearchOptions(
        top_k=top_k,
        regex=regexp,
        case_sensitive=not ignore_case,
        include_globs=list(includes),
        exclude_globs=list(excludes),
        exclude_dirs=list(exclude_dirs),
        no_rank_boosts=no_rank_boosts,
    )
    hits = searcher.search(query, opts)
    _print_hits(hits, json_out, files_only, count_only, line_numbers)


@cli.command()
@click.pass_context
def init(ctx):
    """Build (or refresh) the index for the project."""
    indexer = _indexer(
        ctx.obj["path"], ctx.obj["model"], ctx.obj["index_dir"], ctx.obj["device"]
    )
    stats = indexer.update(
        progress=lambda done, total: click.echo(
            f"\r  embedding {done}/{total}", nl=False
        )
    )
    click.echo(f"\nindexed: {stats}")


@cli.command()
@click.pass_context
def status(ctx):
    """Show index status for the project."""
    indexer = _indexer(
        ctx.obj["path"], ctx.obj["model"], ctx.obj["index_dir"], ctx.obj["device"]
    )
    click.echo(jsonlib.dumps(indexer.status(), indent=2))


@cli.command()
@click.option("--all", "all_", is_flag=True, help="clear every cached index")
@click.pass_context
def clear(ctx, all_):
    """Delete the project's index (or all cached indexes with --all)."""
    if all_:
        import shutil

        from nextplaid_tpu_torch.codesearch.indexer import cache_root

        shutil.rmtree(cache_root(), ignore_errors=True)
        click.echo("cleared all code-search indexes")
        return
    indexer = _indexer(
        ctx.obj["path"], ctx.obj["model"], ctx.obj["index_dir"], ctx.obj["device"]
    )
    indexer.clear()
    click.echo("cleared")


@cli.command()
@click.pass_context
def stats(ctx):
    """Index statistics (files, units, per-language counts)."""
    from collections import Counter

    from nextplaid_tpu_torch import filtering

    indexer = _indexer(
        ctx.obj["path"], ctx.obj["model"], ctx.obj["index_dir"], ctx.obj["device"]
    )
    rows = filtering.get(str(indexer.index_dir))
    langs = Counter(r.get("language") for r in rows)
    types = Counter(r.get("unit_type") for r in rows)
    click.echo(
        jsonlib.dumps(
            {
                **indexer.status(),
                "languages": dict(langs),
                "unit_types": dict(types),
            },
            indent=2,
        )
    )


def _session_hook(path_, model, index_dir, device):
    """Agent session-start context (reference --session-hook, cli.rs /
    install/hook.json SessionStart): a short status blurb the agent can
    inject into its context. Never fails — agents call this on every start."""
    try:
        indexer = _indexer(path_, model, index_dir, device)
        st = indexer.status()
        click.echo(
            "cgrep semantic code search is available for this project "
            f"({st.get('files', '?')} files / {st.get('units', '?')} units "
            "indexed). Use `cgrep \"natural language query\"` to search by "
            "meaning instead of grep."
        )
    except Exception:
        click.echo(
            "cgrep semantic code search is available. Use `cgrep init` to "
            "build the index, then `cgrep \"query\"` to search by meaning."
        )


@cli.command("set-model")
@click.argument("model")
def set_model(model):
    """Persist MODEL (a local checkpoint dir or HF hub repo id) as the
    default encoder (reference commands/config.rs:22 cmd_set_model).

    Hub ids are resolved through the HF cache on first use — the download
    happens at index/search time, not here (matching the reference, which
    also defers the fetch to the ORT bootstrap)."""
    if os.path.isdir(model):
        model = os.path.abspath(model)
    elif "/" not in model or model.count("/") > 1:
        raise click.ClickException(
            f"{model!r} is neither a directory nor an 'org/name' hub id"
        )
    cfg = CgrepConfig.load()
    cfg.default_model = model
    p = cfg.save()
    click.echo(f"default_model = {cfg.default_model}\nwrote {p}")


@cli.command("settings")
@click.option("--set", "set_kv", nargs=2, multiple=True,
              metavar="KEY VALUE", help="set a config key")
@click.option("--unset", "unset_keys", multiple=True, metavar="KEY")
def settings(set_kv, unset_keys):
    """Show or edit persisted settings (reference commands/config.rs:97).

    Keys: default_model, default_k, pool_factor, batch_size, verbose,
    relative_paths, hybrid_search, hybrid_alpha, extra_ignore,
    force_include (lists are comma-separated).
    """
    cfg = CgrepConfig.load()
    changed = False
    for key, value in set_kv:
        try:
            cfg.set_value(key, value)
        except (KeyError, ValueError) as e:
            raise click.ClickException(str(e))
        changed = True
    for key in unset_keys:
        try:
            cfg.unset(key)
        except KeyError as e:
            raise click.ClickException(str(e))
        changed = True
    if changed:
        cfg.save()
    from nextplaid_tpu_torch.codesearch.config import config_path

    click.echo(jsonlib.dumps(cfg.as_display_dict(), indent=2))
    click.echo(f"# {config_path()}")


@cli.command("update")
def self_update():
    """Self-update (reference commands/update.rs downloads a new binary).

    This build is a Python package: upgrading means `pip install --upgrade
    nextplaid-tpu`, which needs network access this image doesn't have.
    """
    import importlib.metadata

    try:
        ver = importlib.metadata.version("nextplaid-tpu")
    except importlib.metadata.PackageNotFoundError:
        ver = "unknown (not installed as a package)"
    click.echo(f"current version: {ver}")
    raise click.ClickException(
        "self-update needs network access (pip install --upgrade "
        "nextplaid-tpu); this environment has no egress. (Searching for "
        "the word 'update'? command names are reserved — use: "
        "cgrep -- update)"
    )


@cli.command("install-agent")
@click.option(
    "--agent",
    type=click.Choice(["claude-code", "opencode", "codex", "hermes"]),
    default="claude-code",
)
@click.pass_context
def install_agent(ctx, agent):
    """Install cgrep integration for an agent CLI (reference
    colgrep/src/install/*.rs: Claude Code plugin; AGENTS.md section for
    OpenCode / Codex / Hermes)."""
    from nextplaid_tpu_torch.codesearch import install as inst

    if agent == "claude-code":
        path = inst.install_claude_code(ctx.obj["path"])
        click.echo(f"wrote {path}")
        click.echo("optional settings.json hook snippet:")
        click.echo(inst.hook_snippet_json())
    else:
        path = inst.install_agents_md(agent)
        click.echo(f"wrote cgrep section to {path}")


@cli.command("uninstall-agent")
@click.option(
    "--agent",
    type=click.Choice(["opencode", "codex", "hermes"]),
    required=True,
)
def uninstall_agent(agent):
    """Remove the cgrep AGENTS.md section for an agent CLI."""
    from nextplaid_tpu_torch.codesearch import install as inst

    if inst.uninstall_agents_md(agent):
        click.echo("removed")
    else:
        click.echo("nothing to remove")


def main():
    cli(obj={})


if __name__ == "__main__":
    main()
