"""Index build in both packages on one small corpus.

From the same centroids, the two builds must write the same bytes: codes,
residuals, IVF and bucket tables. Trained end to end, centroids come out of
f32 sums taken in another order over four Lloyd iterations and a
renormalization, so they (and the bucket tables derived from them) agree to
5e-5 (the largest gap seen on this corpus is 1.1e-5); codes and IVF must
still be equal, and a residual value may land in another bucket only where
it lies within 5e-5 of every cutoff between the two buckets. (With ~2
tokens per centroid many residuals are ~0, and three cutoffs sit within
1e-6 of 0.) Each package loads the directory the other wrote.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as jax_index
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    IndexConfig,
    create_index,
    create_index_from_device,
)
from nextplaid_tpu_torch.index.build import build_ivf
from nextplaid_tpu_torch.ops.codec import unpack_buckets
from nextplaid_tpu_torch.storage.npy import IndexLayout


def _corpus(seed=0, n_docs=40, dim=32):
    rng = np.random.default_rng(seed)
    topics = rng.standard_normal((12, dim)).astype(np.float32)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(8, 41))
        t = topics[rng.integers(0, 12, n)] + 0.3 * rng.standard_normal((n, dim))
        docs.append((t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32))
    return docs


def _read(path):
    layout = IndexLayout(path)
    out = {
        name: np.load(getattr(layout, name))
        for name in ("centroids", "bucket_cutoffs", "bucket_weights",
                     "avg_residual", "cluster_threshold", "ivf", "ivf_lengths")
    }
    out["codes"] = np.load(layout.chunk_codes(0))
    out["residuals"] = np.load(layout.chunk_residuals(0))
    out["metadata"] = IndexLayout(path).metadata.read_text()
    return out


def _assert_same_index(ours, ref, docs=None, nbits=None):
    """Equal files; with `docs`, a residual bucket may differ only for a
    value within 5e-5 of the cutoffs it crossed (centroids trained
    separately)."""
    names = ["codes", "ivf", "ivf_lengths"] + (["residuals"] if docs is None else [])
    for name in names:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
        assert ours[name].dtype == ref[name].dtype, name
    for name in ("centroids", "bucket_cutoffs", "bucket_weights",
                 "avg_residual", "cluster_threshold"):
        np.testing.assert_allclose(ours[name], ref[name], rtol=1e-4, atol=5e-5,
                                   err_msg=name)
    assert ours["metadata"] == ref["metadata"]
    if docs is None:
        return
    unpack = lambda r: unpack_buckets(torch.from_numpy(r), nbits).numpy()
    b_ours, b_ref = unpack(ours["residuals"]), unpack(ref["residuals"])
    differ = b_ours != b_ref
    res = (np.concatenate(docs) - ref["centroids"][ref["codes"]])[differ]
    lo, hi = np.minimum(b_ours, b_ref)[differ], np.maximum(b_ours, b_ref)[differ]
    cut = ref["bucket_cutoffs"]
    crossed = (np.arange(cut.size) >= lo[:, None]) & (np.arange(cut.size) < hi[:, None])
    near = np.abs(res[:, None] - cut[None, :]) < 5e-5
    assert (near | ~crossed).all()


@pytest.mark.parametrize("nbits", [2, 4])
def test_create_index_same_centroids_same_bytes(nbits, tmp_path):
    docs = _corpus()
    ref = str(tmp_path / "jax")
    jax_index.create_index(docs, ref, jax_index.IndexConfig(nbits=nbits, seed=42))
    ours = str(tmp_path / "torch")
    create_index(docs, ours, IndexConfig(nbits=nbits, seed=42),
                 centroids=_read(ref)["centroids"], device="cpu")
    a, b = _read(ours), _read(ref)
    _assert_same_index(a, b)
    for name in ("centroids", "bucket_cutoffs", "bucket_weights"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("nbits", [2, 4])
def test_create_index_matches_jax(nbits, tmp_path):
    docs = _corpus()
    ours, ref = str(tmp_path / "torch"), str(tmp_path / "jax")
    create_index(docs, ours, IndexConfig(nbits=nbits, seed=42), device="cpu")
    jax_index.create_index(docs, ref, jax_index.IndexConfig(nbits=nbits, seed=42))
    _assert_same_index(_read(ours), _read(ref), docs, nbits)


@pytest.mark.parametrize("nbits", [2, 4])
def test_create_index_from_device_matches_jax(nbits, tmp_path):
    docs = _corpus(seed=1)
    flat = np.concatenate(docs)
    doclens = [d.shape[0] for d in docs]
    ours, ref = str(tmp_path / "torch"), str(tmp_path / "jax")
    create_index_from_device(
        torch.from_numpy(flat), doclens, ours, IndexConfig(nbits=nbits, seed=42),
        device="cpu",
    )
    jax_index.create_index_from_device(
        jnp.asarray(flat), doclens, ref, jax_index.IndexConfig(nbits=nbits, seed=42)
    )
    _assert_same_index(_read(ours), _read(ref), docs, nbits)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_loads_the_others_index(writer, tmp_path):
    docs = _corpus(seed=2)
    path = str(tmp_path / "idx")
    if writer == "torch":
        create_index(docs, path, IndexConfig(nbits=4, seed=42), device="cpu")
    else:
        jax_index.create_index(docs, path, jax_index.IndexConfig(nbits=4, seed=42))
    ours = DeviceIndex.load(path, device="cpu")
    ref = jax_index.DeviceIndex.load(path)
    assert ours.num_documents == ref.num_documents == len(docs)
    assert ours.num_embeddings == ref.num_embeddings
    assert (ours.nbits, ours.max_doclen) == (ref.nbits, ref.max_doclen)
    for name in ("centroids", "codes", "residuals", "doc_offsets", "doclens",
                 "ivf_offsets", "ivf_doc_ids", "bucket_cutoffs",
                 "bucket_weights", "avg_residual"):
        np.testing.assert_array_equal(
            getattr(ours, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name,
        )


def test_build_ivf_dedups_and_sorts():
    codes = np.asarray([2, 0, 2, 1, 0, 2, 2], np.int64)
    doclens = np.asarray([3, 0, 4])
    ids, lengths = build_ivf(codes, doclens, 4)
    assert lengths.tolist() == [2, 1, 2, 0]
    assert ids.tolist() == [0, 2, 2, 0, 2]
    want_ids, want_lengths = jax_index.build.build_ivf(codes, doclens, 4)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(lengths, want_lengths)


def test_unported_structure_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_index(_corpus(n_docs=3), str(tmp_path / "i"),
                     IndexConfig(centroid_structure="rq"), device="cpu")
