"""Add/delete stress acceptance of the port: `cycles` rounds of a random
batch of documents with metadata added through
`update_or_create_with_metadata`, then (in 4 of 5 rounds) a random subset of
ids deleted through `delete_with_options`, with these checks after every
operation: the index's document count equals the metadata store's; the
returned ids are the next ones; the metadata ids are dense 0..N-1; the index
loads and answers a search; and at the end every tag is unique. The
reference records the same acceptance in
docs/benchmarks/scifact_stress_test.json (75 cycles, 2,223 deletes).

    python scripts/run_torch_stress_acceptance.py [cycles] [--device cpu] [--out FILE]

Runs on --device (default cuda, which fails without a card). Prints the
run's statistics as JSON and writes them only to --out.
Counterpart of scripts/run_stress_acceptance.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

DIM = 32
# The JAX package's recorded run; this script never writes over it.
JAX_RECORD = os.path.join(ROOT, "docs", "benchmarks", "stress_acceptance.json")


def make_docs(rng, n):
    docs = []
    for _ in range(n):
        t = int(rng.integers(4, 10))
        v = rng.standard_normal((t, DIM)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        docs.append(v)
    return docs


def counts(path):
    """(documents in the index's metadata.json, rows of the metadata store)."""
    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.index.config import Metadata
    from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json

    meta = Metadata.from_dict(load_json(IndexLayout(path).metadata))
    return meta.num_documents, filtering.count(path)


def _check(ok, *what):
    """An acceptance check that holds under `python -O` too."""
    if not ok:
        raise AssertionError(what)


def run_cycles(path: str, cycles: int, add_lo: int = 5, add_hi: int = 30, device=None) -> dict:
    """The acceptance loop on `device`; returns the run's statistics. Draws
    the same random numbers as the JAX package's loop
    (tests/test_stress_cycles.py), so equal seeds give equal statistics."""
    from nextplaid_tpu_torch import filtering
    from nextplaid_tpu_torch.index import DeviceIndex, IndexConfig, SearchParameters, search_batch
    from nextplaid_tpu_torch.index.delete import delete_with_options
    from nextplaid_tpu_torch.index.update import UpdateConfig, update_or_create_with_metadata

    rng = np.random.default_rng(42)
    expected = 0
    next_tag = 0
    total_added = 0
    total_deleted = 0
    delete_ops = 0

    for cycle in range(cycles):
        # Add a random batch with metadata.
        n_add = int(rng.integers(add_lo, add_hi))
        docs = make_docs(rng, n_add)
        meta = [{"tag": next_tag + i, "cycle": cycle} for i in range(n_add)]
        next_tag += n_add
        ids = update_or_create_with_metadata(
            docs, path, IndexConfig(seed=42), UpdateConfig(seed=42), meta, device=device
        )
        expected += n_add
        total_added += n_add
        _check(ids == list(range(expected - n_add, expected)), cycle, "ids", ids)
        nd, db = counts(path)
        _check(nd == db == expected, cycle, "after add", nd, db, expected)

        # Delete a random subset by id (mixed positions, not just a suffix).
        if expected > 8 and rng.random() < 0.8:
            n_del = int(rng.integers(1, max(expected // 3, 2)))
            del_ids = sorted(rng.choice(expected, size=n_del, replace=False).tolist())
            deleted = delete_with_options(del_ids, path)
            _check(deleted == n_del, cycle, "deleted", deleted, n_del)
            expected -= n_del
            total_deleted += n_del
            delete_ops += 1
            nd, db = counts(path)
            _check(nd == db == expected, cycle, "after delete", nd, db, expected)

        # The index loads and answers a search every cycle.
        index = DeviceIndex.load(path, device=device)
        _check(index.num_documents == expected, cycle, "loaded", index.num_documents, expected)
        hits = search_batch(index, [docs[0]], SearchParameters(top_k=3))[0].passage_ids
        _check(len(hits) == min(3, expected) and all(0 <= h < expected for h in hits),
               cycle, "search", hits)
        # Metadata ids are dense 0..N-1.
        rows = filtering.get(path)
        _check([r["_subset_"] for r in rows] == list(range(expected)), cycle, "dense ids")

    # Final integrity: every doc's metadata is unique.
    tags = [r["tag"] for r in filtering.get(path)]
    _check(len(set(tags)) == len(tags), "unique tags")
    return {
        "cycles": cycles,
        "total_documents_added": total_added,
        "total_documents_deleted": total_deleted,
        "delete_operations": delete_ops,
        "final_documents": expected,
        "count_sync_verified_every_op": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cycles", nargs="?", type=int, default=75)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which fails without a card)")
    ap.add_argument("--out", help="write the statistics here (never the JAX package's record)")
    args = ap.parse_args(argv)
    if args.out and os.path.realpath(args.out) == os.path.realpath(JAX_RECORD):
        ap.error(f"--out must not be {JAX_RECORD}: it is the JAX package's record")

    from nextplaid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="stress_accept_") as td:
        t0 = time.perf_counter()
        # 30-120 docs a cycle: the index grows into the thousands and the
        # deletes reach the reference run's ~2.2K.
        stats = run_cycles(os.path.join(td, "stress"), args.cycles, add_lo=30, add_hi=120,
                           device=device)
        stats["elapsed_seconds"] = time.perf_counter() - t0
    stats["benchmark"] = "add_delete_stress_acceptance"
    stats["device"] = str(device)
    stats["reference_equivalent"] = (
        "docs/benchmarks/scifact_stress_test.json (75 cycles, 2223 deletes)")
    stats["verified"] = (
        "index.num_documents == metadata count after every op; metadata ids dense 0..N-1 "
        "after every cycle; unique tags at the end; index loadable+searchable every cycle")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stats, f, indent=2)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
