"""The port's residual codec against the golden index bytes and against
`nextplaid_tpu.ops.codec` on the same random inputs.

Byte outputs (codes, buckets, packed residuals) must be equal. Float outputs
(decompressed tokens) must agree within 1e-6: both sides compute
normalize(centroid + weight) in f32 with the same operations.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextplaid_tpu.ops import codec as jax_codec
from nextplaid_tpu_torch import DeviceIndex
from nextplaid_tpu_torch.index import SearchParameters, search_batch
from nextplaid_tpu_torch.ops import codec

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def fixture(nbits):
    root = os.path.join(GOLDEN, f"index_nbits{nbits}")
    with open(os.path.join(root, "expected.json")) as f:
        return root, json.load(f)


@pytest.mark.parametrize("nbits", [2, 4])
def test_encode_reproduces_golden_bytes(nbits):
    root, exp = fixture(nbits)
    emb = torch.tensor(exp["embeddings"], dtype=torch.float32)
    centroids = torch.from_numpy(np.load(os.path.join(root, "centroids.npy")))
    cutoffs = torch.from_numpy(np.load(os.path.join(root, "bucket_cutoffs.npy")))

    codes = codec.assign_codes(emb, centroids)
    assert codes.tolist() == exp["codes"]
    residuals = codec.compute_residuals(emb, centroids, codes)
    buckets = codec.bucketize(residuals, cutoffs, nbits)
    assert buckets.tolist() == exp["tok_buckets"]
    packed = codec.pack_buckets(buckets, nbits).numpy()
    np.testing.assert_array_equal(
        packed, np.load(os.path.join(root, "0.residuals.npy"))
    )
    assert [bytes(r).hex() for r in packed] == exp["packed_hex"]


@pytest.mark.parametrize("nbits", [2, 4])
def test_decode_reconstructs_golden_values(nbits):
    root, exp = fixture(nbits)
    index = DeviceIndex.load(root, device="cpu")
    assert index.nbits == nbits
    assert index.num_documents == len(exp["doclens"])
    n_tok = sum(exp["doclens"])
    recon = codec.decompress_residuals(
        index.residuals[:n_tok],
        index.codes[:n_tok],
        index.centroids,
        index.bucket_weights,
        nbits,
    )
    np.testing.assert_allclose(
        recon.numpy(),
        np.asarray(exp["reconstructed"], np.float32),
        rtol=1e-6,
        atol=1e-6,
    )


@pytest.mark.parametrize("nbits", [2, 4])
def test_exact_search_matches_golden_scores(nbits):
    """Hand-computed MaxSim scores and ranking, through the port's exact
    route (f32 "highest"; 1e-5 as the JAX package's golden test)."""
    root, exp = fixture(nbits)
    index = DeviceIndex.load(root, device="cpu")
    query = np.asarray(exp["query"], np.float32)
    (res,) = search_batch(index, [query], SearchParameters(top_k=3, mode="exact"))
    assert res.passage_ids == exp["expected_order"]
    expected = [exp["expected_scores"][i] for i in exp["expected_order"]]
    np.testing.assert_allclose(res.scores, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_pack_unpack_match_jax(nbits):
    rng = np.random.default_rng(nbits)
    buckets = rng.integers(0, 1 << nbits, size=(37, 64)).astype(np.int32)
    packed = codec.pack_buckets(torch.from_numpy(buckets), nbits).numpy()
    want = np.asarray(jax_codec.pack_buckets(jnp.asarray(buckets), nbits))
    np.testing.assert_array_equal(packed, want)
    unpacked = codec.unpack_buckets(torch.from_numpy(packed), nbits).numpy()
    np.testing.assert_array_equal(unpacked, buckets)
    np.testing.assert_array_equal(
        unpacked, np.asarray(jax_codec.unpack_buckets(jnp.asarray(want), nbits))
    )


@pytest.mark.parametrize("nbits", [2, 4])
def test_quantize_and_decompress_match_jax(nbits):
    rng = np.random.default_rng(10 + nbits)
    n, k, d = 200, 16, 32
    cents = rng.standard_normal((k, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    emb = cents[rng.integers(0, k, n)] + 0.1 * rng.standard_normal((n, d))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    res = emb - cents[rng.integers(0, k, n)]
    cutoffs, weights = codec.train_codec_buckets(res, nbits)
    jc, jw = jax_codec.train_codec_buckets(res, nbits)
    np.testing.assert_array_equal(cutoffs, jc)
    np.testing.assert_array_equal(weights, jw)

    codes = codec.assign_codes(torch.from_numpy(emb), torch.from_numpy(cents))
    jcodes = np.asarray(jax_codec.assign_codes(jnp.asarray(emb), jnp.asarray(cents)))
    np.testing.assert_array_equal(codes.numpy(), jcodes)

    packed = codec.quantize_residuals(
        torch.from_numpy(res), torch.from_numpy(cutoffs), nbits
    ).numpy()
    jpacked = np.asarray(
        jax_codec.quantize_residuals(jnp.asarray(res), jnp.asarray(cutoffs), nbits)
    )
    np.testing.assert_array_equal(packed, jpacked)

    out = codec.decompress_residuals(
        torch.from_numpy(packed), codes, torch.from_numpy(cents),
        torch.from_numpy(weights), nbits,
    ).numpy()
    jout = np.asarray(
        jax_codec.decompress_residuals(
            jnp.asarray(jpacked), jnp.asarray(jcodes), jnp.asarray(cents),
            jnp.asarray(jw), nbits,
        )
    )
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)


def test_bucketize_ties_go_left():
    """A value equal to a cutoff lands in the bucket below it
    (searchsorted side="left"), as in the JAX package."""
    cutoffs = np.asarray([-0.5, 0.0, 0.5], np.float32)
    vals = np.asarray([[-0.5, 0.0, 0.5, 0.7, -0.9, 0.25, 0.0, 0.5]], np.float32)
    got = codec.bucketize(torch.from_numpy(vals), torch.from_numpy(cutoffs), 2)
    want = np.asarray(jax_codec.bucketize(jnp.asarray(vals), jnp.asarray(cutoffs), 2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [[0, 1, 2, 3, 0, 2, 1, 2]]


def test_assign_codes_chunked_equals_whole():
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.standard_normal((100, 16)).astype(np.float32))
    cents = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    whole = codec.assign_codes(emb, cents)
    np.testing.assert_array_equal(
        codec.assign_codes(emb, cents, chunk_rows=7).numpy(), whole.numpy()
    )
    cents[3] = float("nan")  # a NaN centroid never wins
    assert not (codec.assign_codes(emb, cents) == 3).any()
