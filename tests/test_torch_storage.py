"""The port's storage remainder against the JAX package's.

`storage/native.py`: each entry point of the library the port compiles from
`native/nextplaid_host.cpp` (into its own build directory) equals its numpy
version and the JAX module's. `storage/merge_cache.py`: miss, store, hit and
invalidation after a chunk rewrite, read across the packages.
`storage/convert.py`: a fast-plaid-format directory converts to the same
bytes. `load_host_arrays`: the arrays of the JAX package's, with the merge
cache forced on and off.
"""

import filecmp
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

import nextplaid_tpu.index as jax_index
from nextplaid_tpu.index.container import load_host_arrays as jax_load_host_arrays
from nextplaid_tpu.storage import convert as jax_convert
from nextplaid_tpu.storage import merge_cache as jax_merge_cache
from nextplaid_tpu.storage import native as jax_native
from nextplaid_tpu_torch.index.container import load_host_arrays
from nextplaid_tpu_torch.storage import convert, merge_cache, native
from nextplaid_tpu_torch.storage.npy import IndexLayout

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    """A JAX-built index of 60 docs in four chunks."""
    rng = np.random.default_rng(0)
    docs = [
        rng.standard_normal((int(rng.integers(4, 30)), 32)).astype(np.float32)
        for _ in range(60)
    ]
    path = str(tmp_path_factory.mktemp("idx") / "index")
    jax_index.create_index(docs, path, jax_index.IndexConfig(nbits=2, seed=1, batch_size=16))
    return path


def _chunk_paths(path):
    layout = IndexLayout(path)
    n = len(list(Path(path).glob("*.codes.npy")))
    return (
        [str(layout.chunk_codes(i)) for i in range(n)],
        [str(layout.chunk_residuals(i)) for i in range(n)],
    )


def test_library_builds_into_the_port_build_dir():
    assert native.available()
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent == ROOT / "build" / "nextplaid_tpu_torch"
    assert native.SOURCE == ROOT / "native" / "nextplaid_host.cpp"


@pytest.mark.parametrize("nbits", [2, 4])
def test_pack_unpack_native_equals_numpy(nbits):
    rng = np.random.default_rng(nbits)
    buckets = rng.integers(0, 1 << nbits, (37, 64)).astype(np.int32)
    packed = native.pack_residuals(buckets, nbits)
    np.testing.assert_array_equal(packed, native.pack_residuals_reference(buckets, nbits))
    np.testing.assert_array_equal(packed, jax_native.pack_residuals(buckets, nbits))
    unpacked = native.unpack_residuals(packed, nbits)
    np.testing.assert_array_equal(unpacked, buckets)
    np.testing.assert_array_equal(unpacked, native.unpack_residuals_reference(packed, nbits))


def test_bucketize_and_f16_native_equal_numpy():
    rng = np.random.default_rng(3)
    values = rng.standard_normal((19, 8)).astype(np.float32)
    cutoffs = np.sort(rng.standard_normal(15)).astype(np.float32)
    values[0, :3] = cutoffs[:3]  # on a cutoff: the left side
    got = native.bucketize(values, cutoffs)
    np.testing.assert_array_equal(got, native.bucketize_reference(values, cutoffs))
    np.testing.assert_array_equal(got, jax_native.bucketize(values, cutoffs))
    half = np.concatenate([
        rng.standard_normal(50).astype(np.float16),
        np.asarray([0, -0.0, 6e-8, -6e-8, 65504, np.inf, -np.inf], np.float16),
    ])
    wide = native.f16_to_f32(half)
    assert wide.dtype == np.float32
    np.testing.assert_array_equal(wide, native.f16_to_f32_reference(half))
    np.testing.assert_array_equal(wide, jax_native.f16_to_f32(half))


def test_merge_chunk_payloads_equals_concatenation(index_dir):
    code_paths, res_paths = _chunk_paths(index_dir)
    assert len(code_paths) >= 2
    codes = np.concatenate([np.load(p) for p in code_paths])
    residuals = np.concatenate([np.load(p) for p in res_paths])
    np.testing.assert_array_equal(native.merge_chunk_payloads(code_paths, codes.dtype), codes)
    merged = native.merge_chunk_payloads(res_paths, np.uint8, (residuals.shape[1],))
    np.testing.assert_array_equal(merged, residuals)
    assert native.merge_chunk_payloads([], np.int64) is None


def test_without_library_numpy_serves(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    buckets = np.random.default_rng(4).integers(0, 4, (5, 16)).astype(np.int32)
    assert not native.available()
    np.testing.assert_array_equal(
        native.pack_residuals(buckets, 2), jax_native.pack_residuals(buckets, 2)
    )
    assert native.merge_chunk_payloads(["x"], np.int64) is None


@pytest.mark.parametrize("flag", ["0", "1"])
def test_load_host_arrays_matches_jax(index_dir, tmp_path, monkeypatch, flag):
    path = str(tmp_path / "idx")
    shutil.copytree(index_dir, path)
    monkeypatch.setenv("NEXT_PLAID_MERGE_CACHE", flag)
    for _ in range(2):  # with the flag on: a miss and store, then a hit
        ours, ref = load_host_arrays(path), jax_load_host_arrays(path)
        for key in ("centroids", "bucket_cutoffs", "bucket_weights", "avg_residual",
                    "codes", "residuals", "doclens", "ivf", "ivf_lengths"):
            np.testing.assert_array_equal(ours[key], np.asarray(ref[key]), err_msg=key)
            assert ours[key].dtype == np.asarray(ref[key]).dtype, key
        assert ours["meta"].to_dict() == ref["meta"].to_dict()
    assert os.path.exists(os.path.join(path, "merged", "manifest.json")) == (flag == "1")


def test_merge_cache_miss_store_hit_invalidate(index_dir, tmp_path, monkeypatch):
    path = str(tmp_path / "idx")
    shutil.copytree(index_dir, path)
    code_paths, res_paths = _chunk_paths(path)
    root = Path(path)
    assert merge_cache.enabled(1 << 30, 2) and not merge_cache.enabled(1 << 20, 2)
    monkeypatch.setenv("NEXT_PLAID_MERGE_CACHE", "1")
    assert merge_cache.load_merged(root, code_paths, res_paths) is None  # miss
    fresh = load_host_arrays(path)  # merges, stores
    for hit in (
        merge_cache.load_merged(root, code_paths, res_paths),
        jax_merge_cache.load_merged(root, code_paths, res_paths),
    ):
        assert hit is not None
        np.testing.assert_array_equal(hit[0].astype(np.int32), fresh["codes"])
        np.testing.assert_array_equal(hit[1], fresh["residuals"])
    manifest = (root / "merged" / "manifest.json").read_text()

    # A chunk rewritten with other codes invalidates the manifest in both
    # packages; the next load merges again and stores a new manifest.
    codes0 = np.load(code_paths[0])
    changed = (codes0 + 1) % int(fresh["centroids"].shape[0])
    os.unlink(code_paths[0])
    np.save(code_paths[0], changed)
    assert merge_cache.load_merged(root, code_paths, res_paths) is None
    assert jax_merge_cache.load_merged(root, code_paths, res_paths) is None
    again = load_host_arrays(path)
    np.testing.assert_array_equal(again["codes"][: len(changed)], changed.astype(np.int32))
    assert (root / "merged" / "manifest.json").read_text() != manifest
    assert merge_cache.load_merged(root, code_paths, res_paths) is not None


def _to_fastplaid(src, dst):
    """A copy of `src` as fast-plaid writes it: float tables in f16,
    `ivf_lengths` as i64, residual chunks with the '<u1' descriptor."""
    shutil.copytree(src, dst)
    for name in ("centroids", "avg_residual", "bucket_cutoffs", "bucket_weights"):
        p = os.path.join(dst, f"{name}.npy")
        np.save(p, np.load(p).astype(np.float16))
    p = os.path.join(dst, "ivf_lengths.npy")
    np.save(p, np.load(p).astype(np.int64))
    for p in Path(dst).glob("*.residuals.npy"):
        raw = p.read_bytes()
        assert b"'|u1'" in raw[:256]
        p.write_bytes(raw.replace(b"'|u1'", b"'<u1'", 1))


def test_convert_fastplaid_same_bytes_as_jax(index_dir, tmp_path):
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    _to_fastplaid(index_dir, ours)
    _to_fastplaid(index_dir, ref)
    assert convert.convert_fastplaid_to_nextplaid(ours) is True
    assert jax_convert.convert_fastplaid_to_nextplaid(ref) is True
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(ref))
    differ = [n for n in names if not filecmp.cmp(os.path.join(ours, n),
                                                  os.path.join(ref, n), shallow=False)]
    assert differ == []
    assert np.load(os.path.join(ours, "centroids.npy")).dtype == np.float32
    assert np.load(os.path.join(ours, "ivf_lengths.npy")).dtype == np.int32
    assert convert.convert_fastplaid_to_nextplaid(ours) is False  # idempotent
