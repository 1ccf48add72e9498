"""The port's k-means against `nextplaid_tpu.ops.kmeans`.

Heuristics and sampling are integer/host computations and must be equal.
Lloyd iterations sum points in another order (index_add_ vs the JAX
package's blocked cumulative sums), so centroids agree to rtol/atol 1e-5 in
f32 once both sides assign every point to the same cluster.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextplaid_tpu.ops import kmeans as jax_kmeans
from nextplaid_tpu_torch.ops import kmeans


@pytest.mark.parametrize("n_docs", [1, 7, 100, 5183, 2_000_000])
def test_n_samples_heuristic_equal(n_docs):
    assert kmeans.n_samples_heuristic(n_docs) == jax_kmeans.n_samples_heuristic(n_docs)


@pytest.mark.parametrize("tokens", [0, 1, 100, 1_503_070, 64e6])
def test_num_partitions_heuristic_equal(tokens):
    assert kmeans.num_partitions_heuristic(tokens) == (
        jax_kmeans.num_partitions_heuristic(tokens)
    )


def _clustered(seed, n=600, k=12, d=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 3
    data = centers[rng.integers(0, k, n)] + 0.3 * rng.standard_normal((n, d))
    return data.astype(np.float32), rng


def test_lloyd_matches_jax_from_same_init():
    data, rng = _clustered(0)
    init = data[rng.permutation(data.shape[0])[:12]]
    got = kmeans.lloyd(torch.from_numpy(data), torch.from_numpy(init), iters=4,
                       assign_chunk=128)
    want = np.asarray(
        jax_kmeans.lloyd(jnp.asarray(data), jnp.asarray(init), iters=4,
                         assign_chunk=128)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_lloyd_is_bit_reproducible():
    """Two runs on the same data give the same bits (a resumed streamed
    build retrains and must write the centroids of an uninterrupted one),
    at a size where the rows of one cluster are summed over many threads."""
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.standard_normal((200_000, 32)).astype(np.float32))
    init = data[torch.from_numpy(rng.permutation(200_000)[:512])]
    runs = [kmeans.lloyd(data, init, iters=2) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_lloyd_empty_cluster_keeps_centroid():
    data = np.asarray([[1, 0, 0, 0], [0.9, 0.1, 0, 0]], np.float32)
    init = np.asarray([[1, 1, 1, 1], [-100, 0, 0, 0]], np.float32)
    out = kmeans.lloyd(torch.from_numpy(data), torch.from_numpy(init), iters=2)
    np.testing.assert_allclose(out[1].numpy(), [-100, 0, 0, 0])


@pytest.mark.parametrize("subsample", [False, True])
def test_compute_kmeans_matches_jax(subsample):
    rng = np.random.default_rng(1)
    docs = [
        rng.standard_normal((int(rng.integers(4, 20)), 16)).astype(np.float32)
        for _ in range(60)
    ]
    # max_points_per_centroid=4 forces the per-centroid subsample draw.
    cfg = dict(seed=7, num_partitions=16,
               max_points_per_centroid=4 if subsample else 256)
    got = kmeans.compute_kmeans(docs, kmeans.KMeansConfig(**cfg), device="cpu")
    want = jax_kmeans.compute_kmeans(docs, jax_kmeans.KMeansConfig(**cfg))
    assert got.shape == want.shape == (16, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_training_sample_bit_identical():
    rng = np.random.default_rng(2)
    docs = [rng.standard_normal((9, 8)).astype(np.float32) for _ in range(30)]
    cfg = dict(seed=3, max_points_per_centroid=2)
    data, k, _, host = kmeans.prepare_training_sample(
        docs, kmeans.KMeansConfig(**cfg), device="cpu"
    )
    jdata, jk, _, jhost = jax_kmeans.prepare_training_sample(
        docs, jax_kmeans.KMeansConfig(**cfg)
    )
    assert k == jk
    np.testing.assert_array_equal(host, jhost)
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))


def test_no_device_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    docs = [np.eye(4, 8, dtype=np.float32)] * 3
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kmeans.compute_kmeans(docs, kmeans.KMeansConfig(num_partitions=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kmeans.prepare_training_sample(docs)
