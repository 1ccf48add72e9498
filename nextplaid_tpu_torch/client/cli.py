"""`next-plaid` CLI over the SDK (next-plaid python-sdk cli.py, Typer -> click).

Usage:
  python -m nextplaid_tpu_torch.client.cli --url http://localhost:8080 health
  ... indices list / create / info / delete
  ... add INDEX --file docs.jsonl (text docs with optional metadata)
  ... search INDEX "query text" --top-k 10 [--keyword | --hybrid]
  ... metadata query INDEX "col = ?" -p value
  ... serve --index-dir ./indices [--model DIR]
"""

from __future__ import annotations

import json
import sys

import click

from nextplaid_tpu_torch.client.client import NextPlaidClient
from nextplaid_tpu_torch.client.exceptions import NextPlaidClientError


def _client(ctx) -> NextPlaidClient:
    return NextPlaidClient(ctx.obj["url"])


def _echo(obj) -> None:
    click.echo(json.dumps(obj, indent=2, default=str))


@click.group()
@click.option("--url", default="http://localhost:8080", envvar="NEXT_PLAID_URL")
@click.pass_context
def cli(ctx, url):
    ctx.ensure_object(dict)
    ctx.obj["url"] = url


@cli.command()
@click.pass_context
def health(ctx):
    """Server health summary."""
    _echo(_client(ctx).health())


@cli.group()
def indices():
    """Index management."""


@indices.command("list")
@click.pass_context
def indices_list(ctx):
    _echo(_client(ctx).list_indices())


@indices.command("create")
@click.argument("name")
@click.option("--nbits", type=int, default=None)
@click.option("--max-documents", type=int, default=None)
@click.option("--fts-tokenizer", default=None)
@click.pass_context
def indices_create(ctx, name, nbits, max_documents, fts_tokenizer):
    config = {
        k: v
        for k, v in {
            "nbits": nbits,
            "max_documents": max_documents,
            "fts_tokenizer": fts_tokenizer,
        }.items()
        if v is not None
    }
    _echo(_client(ctx).create_index(name, config or None))


@indices.command("info")
@click.argument("name")
@click.pass_context
def indices_info(ctx, name):
    _echo(_client(ctx).get_index(name))


@indices.command("delete")
@click.argument("name")
@click.pass_context
def indices_delete(ctx, name):
    _echo(_client(ctx).delete_index(name))


@cli.command()
@click.argument("index_name")
@click.option("--file", "file_", type=click.File("r"), default=sys.stdin,
              help="JSONL: {\"text\": ..., \"metadata\": {...}} per line")
@click.option("--batch-size", type=int, default=64)
@click.option("--pool-factor", type=int, default=None)
@click.pass_context
def add(ctx, index_name, file_, batch_size, pool_factor):
    """Add text documents from a JSONL file (server-side encoding)."""
    texts, metadata = [], []
    for line in file_:
        line = line.strip()
        if not line:
            continue
        row = json.loads(line)
        texts.append(row["text"] if isinstance(row, dict) else str(row))
        metadata.append(
            row.get("metadata", {}) if isinstance(row, dict) else {}
        )
    result = _client(ctx).add(
        index_name, texts, metadata, batch_size=batch_size,
        pool_factor=pool_factor,
    )
    _echo(result)


@cli.command()
@click.argument("index_name")
@click.argument("query")
@click.option("--top-k", type=int, default=10)
@click.option("--keyword", is_flag=True, help="BM25 keyword search only")
@click.option("--hybrid", is_flag=True, help="semantic + keyword fusion")
@click.option("--alpha", type=float, default=None)
@click.option("--fusion", default=None)
@click.option("--filter", "filter_condition", default=None)
@click.option("-p", "--param", "params", multiple=True)
@click.pass_context
def search(ctx, index_name, query, top_k, keyword, hybrid, alpha, fusion,
           filter_condition, params):
    """Search an index with a text query."""
    client = _client(ctx)
    kwargs = dict(
        top_k=top_k,
        alpha=alpha,
        fusion=fusion,
        filter_condition=filter_condition,
        filter_parameters=list(params) or None,
    )
    if keyword:
        result = client.keyword_search(
            index_name, [query], top_k=top_k,
            filter_condition=filter_condition,
            filter_parameters=list(params) or None,
        )
    elif hybrid:
        result = client.search(
            index_name, [query], text_query=[query], **kwargs
        )
    else:
        result = client.search(index_name, [query], **kwargs)
    _echo(result)


@cli.group()
def metadata():
    """Metadata operations."""


@metadata.command("query")
@click.argument("index_name")
@click.argument("condition")
@click.option("-p", "--param", "params", multiple=True)
@click.pass_context
def metadata_query(ctx, index_name, condition, params):
    _echo(_client(ctx).query_metadata(index_name, condition, list(params)))


@metadata.command("count")
@click.argument("index_name")
@click.pass_context
def metadata_count(ctx, index_name):
    _echo(_client(ctx).get_metadata_count(index_name))


@metadata.command("get")
@click.argument("index_name")
@click.option("--ids", default=None, help="comma-separated doc ids")
@click.option("--limit", type=int, default=None)
@click.pass_context
def metadata_get(ctx, index_name, ids, limit):
    doc_ids = [int(i) for i in ids.split(",")] if ids else None
    _echo(
        _client(ctx).get_metadata_by_ids(
            index_name, document_ids=doc_ids, limit=limit
        )
    )


@metadata.command("distinct")
@click.argument("index_name")
@click.argument("column")
@click.pass_context
def metadata_distinct(ctx, index_name, column):
    """Distinct string values of a metadata column."""
    _echo(_client(ctx).get_distinct_metadata(index_name, column))


@metadata.command("update")
@click.argument("index_name")
@click.argument("condition")
@click.argument("updates")
@click.option("-p", "--param", "params", multiple=True)
@click.pass_context
def metadata_update(ctx, index_name, condition, updates, params):
    """Update matching rows' columns; UPDATES is a JSON object."""
    import json as _json

    _echo(
        _client(ctx).update_metadata(
            index_name, condition, _json.loads(updates), list(params)
        )
    )


@cli.command()
@click.argument("index_name")
@click.argument("condition")
@click.option("-p", "--param", "params", multiple=True)
@click.option(
    "--wait/--no-wait",
    default=True,
    help="Poll until the batched server-side delete lands (server returns "
    "202 Accepted immediately).",
)
@click.pass_context
def delete(ctx, index_name, condition, params, wait):
    """Delete documents matching a filter condition."""
    _echo(
        _client(ctx).delete(
            index_name, condition, list(params) or None, wait=wait
        )
    )


@cli.command()
@click.option("--host", default="0.0.0.0")
@click.option("--port", type=int, default=8080)
@click.option("--index-dir", default="./indices")
@click.option("--model", default=None)
@click.option("--batch-size", type=int, default=32)
@click.option("--device", default=None, help="torch device (default cuda)")
def serve(host, port, index_dir, model, batch_size, device):
    """Run the API server."""
    from nextplaid_tpu_torch.api.server import main as server_main

    argv = [
        "--host", host, "--port", str(port), "--index-dir", index_dir,
        "--batch-size", str(batch_size),
    ]
    if model:
        argv += ["--model", model]
    if device:
        argv += ["--device", device]
    server_main(argv)


def main():
    try:
        cli(obj={})
    except NextPlaidClientError as e:
        click.echo(f"error: {e}", err=True)
        sys.exit(1)


@cli.command()
@click.argument("texts", nargs=-1, required=True)
@click.option("--input-type", type=click.Choice(["query", "document"]),
              default="document")
@click.option("--pool-factor", type=int, default=None)
@click.pass_context
def encode(ctx, texts, input_type, pool_factor):
    """Encode texts server-side; prints shapes (embeddings via SDK)."""
    arrays = _client(ctx).encode(
        list(texts), input_type=input_type, pool_factor=pool_factor
    )
    _echo([{"tokens": a.shape[0], "dim": a.shape[1]} for a in arrays])


@cli.command()
@click.argument("query")
@click.argument("documents", nargs=-1, required=True)
@click.option("--pool-factor", type=int, default=None)
@click.pass_context
def rerank(ctx, query, documents, pool_factor):
    """Rerank candidate documents against a query (server-side encoding)."""
    _echo(_client(ctx).rerank(query, list(documents), pool_factor=pool_factor))


if __name__ == "__main__":
    main()
