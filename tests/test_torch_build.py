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

A streamed build interrupted and resumed writes the bytes of the JAX
package's resumed build (with the JAX Lloyd iterations carried across) and
of an uninterrupted build, skips the chunks already written, and refuses a
directory trained under another config or holding another corpus.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as jax_index
from nextplaid_tpu.ops import kmeans as jax_kmeans
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    IndexConfig,
    create_index,
    create_index_from_device,
    create_index_streamed,
)
from nextplaid_tpu_torch.index.build import DeviceChunk, build_ivf
from nextplaid_tpu_torch.ops import kmeans as torch_kmeans
from nextplaid_tpu_torch.ops.codec import unpack_buckets
from nextplaid_tpu_torch.storage.npy import IndexLayout
from nextplaid_tpu_torch.utils.errors import StorageError


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
    """The RQ structure, once refused, is ported (tests/test_torch_rq.py):
    an "rq" build writes the factored codebook beside the flat table, whose
    K it factors, and "auto" stays flat."""
    docs = _corpus(n_docs=3)
    meta = create_index(docs, str(tmp_path / "i"),
                        IndexConfig(centroid_structure="rq"), device="cpu")
    layout = IndexLayout(str(tmp_path / "i"))
    c, f = np.load(layout.rq_coarse).shape[0], np.load(layout.rq_fine).shape[0]
    assert c * f == meta.num_partitions
    create_index(docs, str(tmp_path / "i"), IndexConfig(), device="cpu")
    assert not layout.rq_coarse.exists() and not layout.rq_fine.exists()


# ---------------------------------------------------------------------------
# Streamed build: resume after an interruption
# ---------------------------------------------------------------------------


class _Interrupted(RuntimeError):
    pass


def _device_chunks(docs, to_tensor, chunk_docs=10, stop=None):
    for i, s in enumerate(range(0, len(docs), chunk_docs)):
        if i == stop:
            raise _Interrupted(f"chunk {i}")
        batch = docs[s : s + chunk_docs]
        yield (to_tensor(np.concatenate(batch)),
               np.asarray([d.shape[0] for d in batch], np.int64))


def _torch_build(docs, path, cfg=None, stop=None, resume=False):
    chunks = (DeviceChunk(tokens=t, doclens=d)
              for t, d in _device_chunks(docs, torch.from_numpy, stop=stop))
    flat = np.concatenate(docs)
    return create_index_streamed(
        chunks, path, cfg or IndexConfig(nbits=2, seed=42),
        sample_tokens=torch.from_numpy(flat), est_total_tokens=flat.shape[0],
        resume=resume, device="cpu",
    )


def _jax_build(docs, path, stop=None, resume=False):
    chunks = (jax_index.build.DeviceChunk(tokens=t, doclens=d)
              for t, d in _device_chunks(docs, jnp.asarray, stop=stop))
    flat = np.concatenate(docs)
    return jax_index.create_index_streamed(
        chunks, path, jax_index.IndexConfig(nbits=2, seed=42),
        sample_tokens=jnp.asarray(flat), est_total_tokens=flat.shape[0], resume=resume,
    )


def _files(path):
    return sorted(n for n in os.listdir(path) if not n.startswith(".nextplaid"))


def _assert_same_files(a, b):
    assert _files(a) == _files(b)
    differ = [n for n in _files(a)
              if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)]
    assert differ == []


@pytest.fixture
def carried_lloyd(monkeypatch):
    """The port's Lloyd iterations return the JAX package's for the same
    inputs, so both packages train the same centroids."""

    def jax_lloyd(data, init, iters, assign_chunk=65536):
        out = jax_kmeans.lloyd(jnp.asarray(data.numpy()), jnp.asarray(init.numpy()),
                               iters=iters, assign_chunk=assign_chunk)
        return torch.from_numpy(np.array(out))

    monkeypatch.setattr(torch_kmeans, "lloyd", jax_lloyd)


def test_resumed_streamed_build_matches_jax(carried_lloyd, tmp_path):
    docs = _corpus(seed=3)
    ours, ref, fresh = (str(tmp_path / n) for n in ("torch", "jax", "fresh"))
    with pytest.raises(_Interrupted):
        _torch_build(docs, ours, stop=2)
    with pytest.raises(_Interrupted):
        _jax_build(docs, ref, stop=2)
    written = [n for n in _files(ours) if n.split(".")[0] in ("0", "1") or
               n in ("doclens.0.json", "doclens.1.json")]
    assert len(written) == 8 and not os.path.exists(os.path.join(ours, "metadata.json"))
    mtimes = {n: os.stat(os.path.join(ours, n)).st_mtime_ns for n in written}
    meta = _torch_build(docs, ours, resume=True)
    _jax_build(docs, ref, resume=True)
    assert meta.num_chunks == 4 and meta.num_embeddings == sum(len(d) for d in docs)
    assert {n: os.stat(os.path.join(ours, n)).st_mtime_ns for n in written} == mtimes
    _assert_same_files(ours, ref)
    _torch_build(docs, fresh)
    _assert_same_files(ours, fresh)


def test_resume_refuses_another_fingerprint_or_corpus(tmp_path):
    docs = _corpus(seed=4)
    path = str(tmp_path / "idx")
    with pytest.raises(_Interrupted):
        _torch_build(docs, path, stop=2)
    for cfg in (IndexConfig(nbits=4, seed=42), IndexConfig(nbits=2, seed=7)):
        with pytest.raises(StorageError, match="resume refused"):
            _torch_build(docs, path, cfg, resume=True)
    moved = list(docs)
    moved[0], moved[1] = docs[0][:-1], np.concatenate([docs[0][-1:], docs[1]])
    with pytest.raises(StorageError, match="different corpus"):
        _torch_build(moved, path, resume=True)
    assert _torch_build(docs, path, resume=True).num_documents == len(docs)


def test_resume_without_fingerprint_retrains(tmp_path, caplog):
    docs = _corpus(seed=5)
    path, fresh = str(tmp_path / "idx"), str(tmp_path / "fresh")
    with pytest.raises(_Interrupted):
        _torch_build(docs, path, stop=2)
    os.unlink(IndexLayout(path).streamed_fingerprint)
    with caplog.at_level("WARNING", logger="nextplaid_tpu_torch.index.build"):
        _torch_build(docs, path, resume=True)
    assert any("no fingerprint file" in r.getMessage() for r in caplog.records)
    assert IndexLayout(path).streamed_fingerprint.exists()
    _torch_build(docs, fresh)
    _assert_same_files(path, fresh)


def test_resume_over_rq_sidecars_raises(tmp_path):
    """A resume reloads RQ sidecars as the codebook (tests/test_torch_rq.py);
    sidecars that do not factor the centroid table are refused."""
    docs = _corpus(seed=6)
    path = str(tmp_path / "idx")
    with pytest.raises(_Interrupted):
        _torch_build(docs, path, stop=1)
    layout = IndexLayout(path)
    np.save(layout.rq_coarse, np.zeros((2, 32), np.float32))
    np.save(layout.rq_fine, np.zeros((2, 32), np.float32))
    with pytest.raises(StorageError, match="RQ sidecars"):
        _torch_build(docs, path, resume=True)
