"""Two processes, one mesh: the port's `init_distributed` over gloo on the
CPU, the counterpart of tests/test_multihost.py.

The test spawns this file twice as `__main__` (ranks 0 and 1, 4 CPU shards
each, one 8-shard mesh), wired only through the NEXT_PLAID_COORDINATOR /
NEXT_PLAID_NUM_PROCESSES / NEXT_PLAID_PROCESS_ID environment variables.
Each rank checks a cross-process sum and the merged results of one
sharded search of an index that rank 0 builds, against the single-device
oracle (equal ids, scores within 1e-4). The worker imports neither jax nor
the JAX package.
"""

import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER_TIMEOUT_S = 300
RTOL = ATOL = 1e-4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_search(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("NEXT_PLAID_")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(env, NEXT_PLAID_COORDINATOR=f"localhost:{port}",
                     NEXT_PLAID_NUM_PROCESSES="2", NEXT_PLAID_PROCESS_ID=str(rank)),
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"RANK {rank} MULTIHOST OK" in out


def _corpus(num_docs=96, dim=32, seed=7):
    import numpy as np

    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(num_docs):
        v = rng.standard_normal((int(rng.integers(3, 13)), dim)).astype(np.float32)
        docs.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    return docs


def _queries(docs, n=4, seed=11):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = docs[int(rng.integers(0, len(docs)))]
        q = base[rng.integers(0, base.shape[0], size=4)] + 0.05 * rng.standard_normal((4, 32))
        out.append((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))
    return out


def worker(workdir: str) -> None:
    """One rank: join the mesh from the environment, check a cross-process
    sum, then one sharded search against rank 0's single-device oracle."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index, search_batch,
    )
    from nextplaid_tpu_torch.parallel import (
        HostIndexData, ShardedIndex, init_distributed, make_mesh, search_batch_sharded,
    )

    rank = int(os.environ["NEXT_PLAID_PROCESS_ID"])
    assert init_distributed(device="cpu") is True
    mesh = make_mesh(devices=["cpu"] * 4)
    assert (mesh.size, mesh.rank, mesh.world_size) == (8, rank, 2)
    assert mesh.host_collectives
    total = mesh.sum([torch.tensor(float(s)) for s in mesh.local_shards])
    assert float(total) == 28.0, float(total)
    gathered = mesh.all_gather([torch.tensor([s, -s]) for s in mesh.local_shards])
    assert gathered[:, 0].tolist() == list(range(8)), gathered

    docs = _corpus()
    queries = _queries(docs)
    path = os.path.join(workdir, "idx")
    marker = os.path.join(workdir, "built.marker")
    params = SearchParameters(top_k=10)
    if rank == 0:
        create_index(docs, path, IndexConfig(nbits=4, seed=42), device="cpu")
        oracle = search_batch(DeviceIndex.load(path, device="cpu"), queries, params)
        with open(os.path.join(workdir, "oracle.json"), "w") as f:
            json.dump([[r.passage_ids, r.scores] for r in oracle], f)
        with open(marker, "w") as f:
            f.write("ok")
    else:
        deadline = time.time() + WORKER_TIMEOUT_S / 2
        while not os.path.exists(marker):
            assert time.time() < deadline, "timed out waiting for rank 0's index"
            time.sleep(0.2)

    sindex = ShardedIndex.shard(HostIndexData.load(path), mesh)
    assert [s.device.type for s in sindex.shards] == ["cpu"] * 4
    results = search_batch_sharded(sindex, queries, params)
    with open(os.path.join(workdir, "oracle.json")) as f:
        oracle = json.load(f)
    for r, (ids, scores) in zip(results, oracle):
        assert r.passage_ids == ids, (r.passage_ids, ids)
        np.testing.assert_allclose(r.scores, scores, rtol=RTOL, atol=ATOL)
    torch.distributed.destroy_process_group()
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "nextplaid_tpu")]
    print(f"RANK {rank} MULTIHOST OK", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1])
