"""One staged search step and a multi-device dry run of the port.

`entry()` returns the staged PLAID search pipeline as a callable with example
arguments on a small synthetic index. `dryrun_multichip(n)` shards a
synthetic index over an n-shard mesh (doc-range shards, replicated
centroids) and runs one sharded staged search, one sharded int8 grid search,
an in-place grid append, a staged append with its stale-IVF exact reroute
and `refresh_ivf`, and two sharded k-means iterations, each checked against
the single-device path; it ends in the `DRYRUN VERIFIED:` line.

    python -m nextplaid_tpu_torch.entry [--device cpu] [--shards N]

Both run on "cuda" unless given a device and raise without a card. On a card
the mesh is the first n cards when that many are visible, else n shards of
the one card; with --device cpu it is n CPU shards. Counterpart of the JAX
package's `__graft_entry__.py`.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device


def _make_synthetic_index(num_docs=64, dim=128, seed=0, device: DeviceLike = None,
                          path: Optional[str] = None):
    """(docs, loaded index, its directory): `num_docs` docs of 4-11 random
    unit tokens, built with nbits 4 under `path` (a new temporary directory
    when None)."""
    from nextplaid_tpu_torch.index import DeviceIndex, IndexConfig, create_index

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(num_docs):
        n = int(rng.integers(4, 12))
        v = rng.standard_normal((n, dim)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        docs.append(v)
    path = path or os.path.join(tempfile.mkdtemp(prefix="graft_idx_"), "idx")
    create_index(docs, path, IndexConfig(nbits=4, seed=42), device=device)
    return docs, DeviceIndex.load(path, device=device), path


def entry(device: DeviceLike = None, path: Optional[str] = None):
    """(fn, example_args): one staged search step over a 64-doc index, for
    8 queries of 32 token rows (8 valid), top-5. `fn(*example_args)` returns
    (doc ids [8, 5], scores [8, 5], overflow [8]) on the index's device."""
    from nextplaid_tpu_torch.index.config import SearchParameters
    from nextplaid_tpu_torch.index.search import PipelineShapes, search_pipeline

    _, index, _ = _make_synthetic_index(device=device, path=path)
    rng = np.random.default_rng(1)
    q_n, tq = 8, 32
    queries = rng.standard_normal((q_n, tq, index.dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=-1, keepdims=True)
    qmask = np.zeros((q_n, tq), bool)
    qmask[:, :8] = True

    params = SearchParameters(top_k=5, n_full_scores=64)
    shapes = PipelineShapes.derive(index, params, q_n, tq)
    fn = functools.partial(search_pipeline, shapes=shapes, subset_mask=None)
    return fn, (index, torch.from_numpy(queries).to(index.device),
                torch.from_numpy(qmask).to(index.device))


def _verify(ok, *what):
    """A check of the dry run that holds under `python -O` too."""
    if not ok:
        raise AssertionError(what)


def _unit_rows(rng, n, dim):
    v = rng.standard_normal((n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     workdir: Optional[str] = None, grid_out: Optional[dict] = None) -> str:
    """One sharded search step of each kind, the sharded appends and one
    sharded k-means run on an `n_devices`-shard mesh (tiny shapes), each
    asserted against the single-device path. Prints the `DRYRUN VERIFIED:`
    line on stdout and stderr and returns it. `grid_out`, when a dict,
    receives the sharded int8 grid index ("sg") and the queries ("queries")
    of the grid search, for holding its kernel at these shapes."""
    from nextplaid_tpu_torch.index import DeviceIndex, search_batch
    from nextplaid_tpu_torch.index.config import SearchParameters
    from nextplaid_tpu_torch.index.update import UpdateConfig, update_or_create
    from nextplaid_tpu_torch.parallel import (
        HostIndexData,
        ShardedGridIndex,
        ShardedIndex,
        lloyd_sharded,
        make_mesh,
        search_batch_sharded,
        search_batch_sharded_grid,
    )

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [device] * n_devices
    mesh = make_mesh(devices=devices)
    with tempfile.TemporaryDirectory(prefix="dryrun_", dir=workdir) as tmp:
        _, index, path = _make_synthetic_index(
            num_docs=48, dim=32, device=device, path=os.path.join(tmp, "idx"))
        sindex = ShardedIndex.shard(HostIndexData.from_device_index(index), mesh)

        rng = np.random.default_rng(2)
        queries = [_unit_rows(rng, 6, 32) for _ in range(4)]
        params = SearchParameters(top_k=5, n_full_scores=32)
        results = search_batch_sharded(sindex, queries, params)
        _verify(len(results) == 4 and all(r.passage_ids for r in results), results)

        # The merged sharded top-k equals the single-device search.
        oracle = search_batch(index, queries, params)
        staged_vs_oracle = all(r.passage_ids == o.passage_ids for r, o in zip(results, oracle))
        _verify(staged_vs_oracle, [r.passage_ids for r in results], [o.passage_ids for o in oracle])

        # Sharded pinned int8 grids: one MaxSim launch a shard, merged top-k.
        sg = ShardedGridIndex.shard_grid_only(path, mesh, "int8")
        gres = search_batch_sharded_grid(sg, queries, SearchParameters(top_k=5))
        _verify(len(gres) == 4 and all(r.passage_ids for r in gres), gres)
        if grid_out is not None:
            grid_out.update(sg=sg, queries=queries)

        # In-place grid ingest: the batch goes into the tail shard.
        new_docs = [_unit_rows(rng, 5, 32) for _ in range(3)]
        info: dict = {}
        update_or_create(new_docs, path, update_config=UpdateConfig(start_from_scratch=0),
                         info_out=info, device=device)
        _verify(info.get("mode") == "buffer", info)
        sg2 = sg.append_batch(*info["encoded"])
        _verify(sg2 is not None and sg2.num_documents == sg.num_documents + 3, sg2)
        gres2 = search_batch_sharded_grid(sg2, [new_docs[0]], SearchParameters(top_k=3))
        _verify(gres2[0].passage_ids[:1] == [sg.num_documents], gres2[0])

        # In-place staged append into reserved capacity: the stale IVF routes
        # to exact search, equal to the single-device oracle over the mutated
        # index on disk; refresh_ivf restores the staged route.
        s_cap = ShardedIndex.shard(HostIndexData.from_device_index(index), mesh,
                                   capacity_factor=1.5)
        s_grown = s_cap.append_batch(*info["encoded"])
        _verify(s_grown is not None and s_grown.ivf_stale, s_grown)
        mutated = DeviceIndex.load(path, device=device)
        oracle2 = search_batch(mutated, [new_docs[0]], SearchParameters(
            top_k=3, mode="exact", stage1_precision="highest"))
        r_stale = search_batch_sharded(s_grown, [new_docs[0]], SearchParameters(top_k=3))
        staged_append_ok = (r_stale[0].passage_ids == oracle2[0].passage_ids
                            and r_stale[0].passage_ids[0] == sg.num_documents)
        _verify(staged_append_ok, r_stale[0], oracle2[0])
        s_fresh = s_grown.refresh_ivf()
        _verify(s_fresh is not None and not s_fresh.ivf_stale, s_fresh)
        r_staged = search_batch_sharded(s_fresh, [new_docs[0]],
                                        SearchParameters(top_k=3, mode="staged"))
        _verify(r_staged[0].passage_ids[:1] == [sg.num_documents], r_staged[0])

        data = rng.standard_normal((256, 32)).astype(np.float32)
        cents = lloyd_sharded(data, data[:8].copy(), iters=2, mesh=mesh)
        cents = np.asarray(torch.as_tensor(cents).cpu())
        _verify(cents.shape == (8, 32), cents.shape)
        np.testing.assert_allclose(np.linalg.norm(cents, axis=1), 1.0, rtol=1e-4)

    # Every flag below is guarded by the checks above.
    summary = (
        f"DRYRUN VERIFIED: devices={n_devices} "
        f"staged_shards={[int(s) for s in sindex.shard_docs]} "
        f"grid_shards={[int(s) for s in sg.shard_docs_host]} "
        f"merged_topk==1dev_oracle={staged_vs_oracle} "
        f"grid_search_ok=True "
        f"append_ok={sg2.num_documents == sg.num_documents + 3} "
        f"append_top1_is_new_doc=True "
        f"staged_append_stale_exact_ok={staged_append_ok} "
        f"staged_append_refresh_ok=True "
        f"kmeans_psum_normalized=True"
    )
    print(summary, flush=True)
    print(summary, file=sys.stderr, flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, which fails without a card)")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh size of the dry run (default: the visible cards up to 8, "
                    "or 8 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fn, fargs = entry(device)
    out = fn(*fargs)
    print("entry OK:", [tuple(o.shape) for o in out], flush=True)
    shards = args.shards or (min(8, torch.cuda.device_count()) if device.type == "cuda" else 8)
    dryrun_multichip(shards, device)
    print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
