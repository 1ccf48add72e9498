"""Index mutations in both packages on copies of one index directory.

One index is built with the JAX package and copied; the same mutation runs
on each copy, the JAX package's on one and the port's (on the CPU) on the
other. Buffer-mode updates, `update_index` and deletes (nonexistent ids,
delete-then-update, the buffer.npy / embeddings.npy side files) must leave
byte-identical files: from identical centroids the two encoders write
identical bytes. The metadata store is compared by its rows.

Centroid expansion and the start-from-scratch rebuild train centroids, and
trained centroids differ across the packages by up to ~1e-5 (f32 sums in
another order). Those paths are compared twice: with the JAX package's
k-means carried across (the port's `compute_kmeans` returns the JAX
result), where the directories must again be byte-identical; and with the
port's own k-means, where outlier sets and centroid counts must be equal,
centroids within 1e-4, and the rest within what that gap allows.
"""

import filecmp
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

import nextplaid_tpu.index as J
from nextplaid_tpu import filtering as JF
from nextplaid_tpu.index import delete as JD
from nextplaid_tpu.index import embeddings as JE
from nextplaid_tpu.index import update as JU
from nextplaid_tpu.ops import kmeans as jax_kmeans
from nextplaid_tpu_torch import filtering as TF
from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters, search_batch
from nextplaid_tpu_torch.index import delete as TD
from nextplaid_tpu_torch.index import embeddings as TE
from nextplaid_tpu_torch.index import update as TU
from nextplaid_tpu_torch.index.config import IndexConfig, Metadata
from nextplaid_tpu_torch.ops import kmeans as torch_kmeans
from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json
from nextplaid_tpu_torch.utils.errors import DeleteError, UpdateError
from tests.test_torch_search import _assert_same_topk

DIM = 32
CPU = "cpu"


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


TOPICS = _unit(np.random.default_rng(0).standard_normal((16, DIM))).astype(np.float32)


def _docs(n, seed, far=False):
    """Clustered docs of 8-40 tokens; `far` docs sit around a direction no
    topic is near, so their tokens are outliers of the base centroids."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(8, 41))
        if far:
            t = np.zeros((k, DIM), np.float32)
            t[:, 7] = 1.0
            t += 0.05 * rng.standard_normal((k, DIM))
        else:
            t = TOPICS[rng.integers(0, 16, k)] + 0.15 * rng.standard_normal((k, DIM))
        out.append(_unit(t).astype(np.float32))
    return out


def _queries(docs, n=6, seed=5):
    rng = np.random.default_rng(seed)
    return [docs[int(i)][:6] for i in rng.integers(0, len(docs), n)]


@pytest.fixture(scope="module")
def base_index(tmp_path_factory):
    """A 120-doc index built by the JAX package (embeddings.npy kept: 120 is
    under the default start-from-scratch threshold)."""
    path = str(tmp_path_factory.mktemp("base") / "idx")
    J.create_index(_docs(120, 1), path, J.IndexConfig(nbits=4, seed=42))
    return path


@pytest.fixture
def pair(base_index, tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    shutil.copytree(base_index, a)
    shutil.copytree(base_index, b)
    return a, b


@pytest.fixture
def carried_kmeans(monkeypatch):
    """The port's k-means returns the JAX package's centroids for the same
    inputs, so trained paths start from identical centroids."""

    def jax_result(docs, config=torch_kmeans.KMeansConfig(), flat_device=None, device=None):
        if flat_device is not None:
            flat_device = jnp.asarray(flat_device.cpu().numpy())
        return jax_kmeans.compute_kmeans(
            docs,
            jax_kmeans.KMeansConfig(
                num_partitions=config.num_partitions,
                kmeans_niters=config.kmeans_niters,
                max_points_per_centroid=config.max_points_per_centroid,
                n_samples_kmeans=config.n_samples_kmeans,
                seed=config.seed,
            ),
            flat_device=flat_device,
        )

    monkeypatch.setattr(torch_kmeans, "compute_kmeans", jax_result)


def _assert_same_dir(a, b):
    """Same file names; every file but the metadata database byte-identical;
    the database's rows equal."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    differ = [
        n for n in names
        if n != "metadata.db" and not n.startswith(("metadata.db-", ".nextplaid"))
        and not filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)
    ]
    assert differ == []
    if "metadata.db" in names:
        assert JF.get(a) == TF.get(b)


def _scratch_off(**kw):
    return dict(start_from_scratch=0, **kw)


# ---------------------------------------------------------------------------
# Buffer mode and update_index: byte-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "case",
    [
        ("one doc", 1, {}),
        ("30 docs", 30, {}),
        ("new chunks (batch_size 7)", 20, {"batch_size": 7}),
        ("two batches accumulate", 12, {}),
    ],
    ids=lambda c: c[0],
)
def test_buffer_update_byte_identical(pair, case):
    label, n, extra = case
    a, b = pair
    new = _docs(n, 2)
    batches = [new[: n // 2], new[n // 2 :]] if label.startswith("two") else [new]
    for batch in batches:
        ia, ib = {}, {}
        ids_a = JU.update(batch, a, JU.UpdateConfig(**_scratch_off(**extra)), info_out=ia)
        ids_b = TU.update(batch, b, TU.UpdateConfig(**_scratch_off(**extra)), info_out=ib, device=CPU)
        assert ids_a == ids_b
        assert ia["mode"] == ib["mode"] == "buffer"
        for x, y in zip(ia["encoded"], ib["encoded"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    _assert_same_dir(a, b)
    assert TU.load_buffer_info(b) == n


@pytest.mark.parametrize("update_threshold", [False, True])
def test_update_index_byte_identical(pair, update_threshold):
    a, b = pair
    new = _docs(9, 3)
    ia, ib = {}, {}
    assert JU.update_index(new, a, update_threshold=update_threshold, info_out=ia) == 9
    assert TU.update_index(new, b, update_threshold=update_threshold, info_out=ib, device=CPU) == 9
    for x, y in zip(ia["encoded"], ib["encoded"]):
        np.testing.assert_array_equal(x, y)
    _assert_same_dir(a, b)


# ---------------------------------------------------------------------------
# Delete: byte-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "ids",
    [[0, 5, 7], [999, -1, 4000], [119, 118, 117], list(range(0, 120, 3)), [3, 3, 3, 60]],
    ids=["middle", "nonexistent", "suffix", "every third", "repeated"],
)
def test_delete_from_index_byte_identical(pair, ids):
    a, b = pair
    assert JD.delete_from_index(ids, a) == TD.delete_from_index(ids, b)
    _assert_same_dir(a, b)


@pytest.mark.parametrize("ids", [[121, 124], [2, 122, 129], [0, 1]], ids=["buffer tail", "both", "base"])
def test_delete_filters_buffer_and_embeddings_files(pair, ids):
    """A buffer-mode update first: deletes then filter buffer.npy (its ids
    are the index's last ones) and embeddings.npy (ids from 0)."""
    a, b = pair
    new = _docs(10, 4)
    JU.update(new, a, JU.UpdateConfig(**_scratch_off()))
    TU.update(new, b, TU.UpdateConfig(**_scratch_off()), device=CPU)
    assert JD.delete_from_index(ids, a) == TD.delete_from_index(ids, b) == len(ids)
    _assert_same_dir(a, b)


def test_delete_then_update(pair):
    a, b = pair
    JD.delete_from_index([4, 50], a)
    TD.delete_from_index([4, 50], b)
    new = _docs(6, 5)
    assert JU.update(new, a, JU.UpdateConfig(**_scratch_off())) == TU.update(
        new, b, TU.UpdateConfig(**_scratch_off()), device=CPU
    )
    _assert_same_dir(a, b)


@pytest.mark.parametrize("ids", [[1, 9, 40], [117, 118, 119]], ids=["middle (FTS rebuild)", "suffix (FTS delete)"])
def test_delete_with_options_syncs_metadata(pair, ids):
    a, b = pair
    rows = [{"n": i, "text": f"word{i} common"} for i in range(120)]
    for path, fmod in ((a, JF), (b, TF)):
        fmod.create(path, rows, list(range(120)))
        fmod.text_search.index(path, rows, list(range(120)))
    assert JD.delete_with_options(ids, a) == TD.delete_with_options(ids, b) == 3
    _assert_same_dir(a, b)
    assert TF.count(b) == 117
    for q in ("word20", "word116", "common"):
        assert JF.text_search.search(a, q, 5) == TF.text_search.search(b, q, 5)


# ---------------------------------------------------------------------------
# Centroid expansion
# ---------------------------------------------------------------------------


def test_find_outliers_same_indices(base_index):
    layout = IndexLayout(base_index)
    cents = np.load(layout.centroids)
    thr = float(np.load(layout.cluster_threshold)[0])
    emb = np.concatenate(_docs(20, 6) + _docs(5, 7, far=True))
    want = JU.find_outliers(emb, cents, thr**2)
    got = TU.find_outliers(emb, cents, thr**2, device=CPU)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert len(want) > 0


def _expand(pair):
    """Buffer 70 docs, then 40 more (30 far away): the second update expands."""
    a, b = pair
    first, second = _docs(70, 8), _docs(10, 9) + _docs(30, 10, far=True)
    modes = []
    for batch in (first, second):
        ia, ib = {}, {}
        ids_a = JU.update(batch, a, JU.UpdateConfig(**_scratch_off()), info_out=ia)
        ids_b = TU.update(batch, b, TU.UpdateConfig(**_scratch_off()), info_out=ib, device=CPU)
        assert ids_a == ids_b
        modes.append((ia["mode"], ib["mode"], "encoded" in ia, "encoded" in ib))
    assert modes == [("buffer", "buffer", True, True), ("expand", "expand", False, False)]
    return a, b


def test_expansion_carried_centroids_byte_identical(pair, carried_kmeans):
    a, b = _expand(pair)
    _assert_same_dir(a, b)


def test_expansion_own_kmeans(pair, base_index):
    a, b = _expand(pair)
    k0 = np.load(IndexLayout(base_index).centroids).shape[0]
    ca, cb = np.load(IndexLayout(a).centroids), np.load(IndexLayout(b).centroids)
    assert ca.shape == cb.shape and ca.shape[0] > k0
    np.testing.assert_allclose(cb, ca, rtol=0, atol=1e-4)
    ma, mb = (Metadata.from_dict(load_json(IndexLayout(p).metadata)) for p in (a, b))
    assert (ma.num_documents, ma.num_partitions, ma.num_embeddings) == (
        mb.num_documents, mb.num_partitions, mb.num_embeddings)
    # Codes decide each token's centroid: near-ties may fall either way.
    codes = [np.load(IndexLayout(p).chunk_codes(0)) for p in (a, b)]
    assert np.mean(codes[0] == codes[1]) > 0.99


# ---------------------------------------------------------------------------
# Start from scratch, update_or_create(_with_metadata), rollback
# ---------------------------------------------------------------------------


def test_scratch_carried_centroids_byte_identical(pair, carried_kmeans):
    a, b = pair
    new = _docs(15, 11)
    ia, ib = {}, {}
    assert JU.update(new, a, info_out=ia) == TU.update(new, b, info_out=ib, device=CPU)
    assert ia["mode"] == ib["mode"] == "scratch"
    _assert_same_dir(a, b)


def test_scratch_own_kmeans_same_topk(pair):
    a, b = pair
    new = _docs(15, 11)
    assert JU.update(new, a) == TU.update(new, b, device=CPU) == list(range(120, 135))
    ref, ours = J.DeviceIndex.load(a), DeviceIndex.load(b, device=CPU)
    assert ours.num_documents == ref.num_documents == 135
    queries = _queries(new)
    want = J.search_batch(ref, queries, J.SearchParameters(top_k=10, mode="exact", stage1_precision="highest"))
    got = search_batch(ours, queries, SearchParameters(top_k=10, mode="exact", stage1_precision="highest"))
    _assert_same_topk(got, want)


def test_update_or_create_with_metadata(tmp_path, carried_kmeans):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    docs = _docs(40, 12)
    meta = [{"n": i, "title": f"title {i}"} for i in range(40)]
    ia, ib = {}, {}
    ids_a = JU.update_or_create_with_metadata(docs[:25], a, J.IndexConfig(nbits=4), metadata=meta[:25], info_out=ia)
    ids_b = TU.update_or_create_with_metadata(
        docs[:25], b, IndexConfig(nbits=4), metadata=meta[:25], info_out=ib, device=CPU)
    assert ids_a == ids_b == list(range(25)) and ia["mode"] == ib["mode"] == "create"
    _assert_same_dir(a, b)
    ids_a = JU.update_or_create_with_metadata(
        docs[25:], a, J.IndexConfig(nbits=4), JU.UpdateConfig(**_scratch_off()), metadata=meta[25:])
    ids_b = TU.update_or_create_with_metadata(
        docs[25:], b, IndexConfig(nbits=4), TU.UpdateConfig(**_scratch_off()), metadata=meta[25:], device=CPU)
    assert ids_a == ids_b == list(range(25, 40))
    _assert_same_dir(a, b)
    assert TF.count(b) == 40 and TF.where_condition(b, "n >= ?", [30]) == list(range(30, 40))


def test_update_or_create_metadata_rollback(pair):
    """A metadata write that fails (a column name the store rejects) rolls
    the just-added docs back out of the vector index in both packages."""
    a, b = pair
    rows = [{"n": i} for i in range(120)]
    JF.create(a, rows, list(range(120)))
    TF.create(b, rows, list(range(120)))
    new = _docs(4, 13)
    bad = [{"bad column!": 1}] * 4
    with pytest.raises(Exception) as ea:
        JU.update_or_create_with_metadata(new, a, J.IndexConfig(), JU.UpdateConfig(**_scratch_off()), metadata=bad)
    with pytest.raises(Exception) as eb:
        TU.update_or_create_with_metadata(
            new, b, IndexConfig(), TU.UpdateConfig(**_scratch_off()), metadata=bad, device=CPU)
    assert type(ea.value).__name__ == type(eb.value).__name__ == "FilteringError"
    for p in (a, b):
        assert load_json(IndexLayout(p).metadata)["num_documents"] == 120
    _assert_same_dir(a, b)


def test_metadata_length_mismatch_raises(pair):
    _, b = pair
    with pytest.raises(UpdateError, match="must match"):
        TU.update_or_create_with_metadata(_docs(2, 14), b, metadata=[{"n": 1}], device=CPU)


def test_rq_sidecars_not_ported(pair):
    _, b = pair
    np.save(os.path.join(b, "rq_coarse.npy"), np.zeros((2, DIM), np.float32))
    with pytest.raises(NotImplementedError, match="RQ"):
        TU.update(_docs(2, 15), b, TU.UpdateConfig(**_scratch_off()), device=CPU)


# ---------------------------------------------------------------------------
# reconstruct_embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("doc_ids", [None, [0, 7, 119], [60]], ids=["all", "some", "one"])
def test_reconstruct_embeddings(base_index, doc_ids):
    want = JE.reconstruct_embeddings(J.DeviceIndex.load(base_index), doc_ids)
    got = TE.reconstruct_embeddings(DeviceIndex.load(base_index, device=CPU), doc_ids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_reconstruct_embeddings_out_of_range(base_index):
    with pytest.raises(DeleteError):
        TE.reconstruct_embeddings(DeviceIndex.load(base_index, device=CPU), [120])


# ---------------------------------------------------------------------------
# Add/delete count-sync cycles (tests/test_stress_cycles.py, in both)
# ---------------------------------------------------------------------------


def _cycles(path, upd, dele, fmod, cycles, **dev):
    rng = np.random.default_rng(42)
    expected, trace = 0, []
    for cycle in range(cycles):
        n_add = int(rng.integers(5, 30))
        docs = [_unit(rng.standard_normal((int(rng.integers(4, 10)), DIM))).astype(np.float32)
                for _ in range(n_add)]
        meta = [{"tag": expected + i, "cycle": cycle} for i in range(n_add)]
        ids = upd(docs, path, metadata=meta, **dev)
        assert ids == list(range(expected, expected + n_add))
        expected += n_add
        assert load_json(IndexLayout(path).metadata)["num_documents"] == fmod.count(path) == expected
        if expected > 8 and rng.random() < 0.8:
            n_del = int(rng.integers(1, max(expected // 3, 2)))
            del_ids = sorted(rng.choice(expected, size=n_del, replace=False).tolist())
            assert dele(del_ids, path) == n_del
            expected -= n_del
            assert load_json(IndexLayout(path).metadata)["num_documents"] == fmod.count(path) == expected
        assert [r["_subset_"] for r in fmod.get(path)] == list(range(expected))
        trace.append((expected, [r["tag"] for r in fmod.get(path)]))
    return trace


def test_add_delete_cycles_count_sync(tmp_path):
    want = _cycles(str(tmp_path / "jax"), JU.update_or_create_with_metadata, JD.delete_with_options, JF, 6)
    got = _cycles(str(tmp_path / "torch"), TU.update_or_create_with_metadata, TD.delete_with_options, TF, 6,
                  device=CPU)
    assert got == want
    index = DeviceIndex.load(str(tmp_path / "torch"), device=CPU)
    assert index.num_documents == want[-1][0]
