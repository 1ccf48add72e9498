"""bench_torch.py and scripts/profile_torch_e2e_composite.py against bench.py
and scripts/profile_e2e_composite.py, on the CPU.

- The corpus helpers: `make_doclens` and `make_queries` bit-equal to
  bench.py's; `make_corpus_device` on the CPU gives unit rows of the asked
  shape at bench.py's stated ~0.74 cosine to their topic (within 0.05).
- The orchestrator: the same three child lines, fed through a stand-in
  `subprocess.run`, give bench.py's `_orchestrate` and the port's the same
  aggregate line (key for key, value for value) apart from the renamed
  `tunnel_probes_per_run`; with one child failing both carry it in
  `runs_failed` and the port exits 1; an unreachable card gives one outage
  line and exit 1, as does `python bench_torch.py` on this box. Without
  BENCH_IDX, the temporary index directory that `_orchestrate` or
  `run_once` made is gone when it returns.
- `run_once` small (300 docs, 16 queries, 4 passes) over a BENCH_IDX that
  the JAX package built from the port's corpus: its top-10 equals JAX
  `search_batch`'s on the same index and queries (tie tolerance of
  tests/test_torch_search.py), its keys are bench.py's child keys with the
  renames, for both pins.
- `mfu` on a bf16 and a doc-major int8 grid shape against the formula with
  the H100 peaks.
- The composite at E2E_DOCS 48, E2E_QUERIES 8: texts, queries and the
  encoders' token ids equal the JAX script's; with the JAX random weights
  and k-means carried across, both forwards in float32 and the port's
  document embeddings given to the JAX server, both mains pass the overlap
  gate, print lines with the same keys, and the port's API top-10 equals
  the JAX composite's for every query (tie tolerance of
  tests/test_torch_search.py); the port writes nothing under
  docs/benchmarks/.
- Neither new file loads jax (a subprocess).
"""

import ast
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.encoder.colbert as jax_colbert
import nextplaid_tpu.encoder.model as JM
import nextplaid_tpu.index as J
from nextplaid_tpu_torch.encoder import model as TM
from nextplaid_tpu_torch.index import DeviceIndex
from tests.test_torch_search import _assert_same_topk
from tests.test_torch_update import carried_kmeans  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import bench_torch  # noqa: E402

COMPOSITE = os.path.join(ROOT, "scripts", "profile_torch_e2e_composite.py")
JAX_COMPOSITE = os.path.join(ROOT, "scripts", "profile_e2e_composite.py")
# bench.py's keys the port renames (the inner keys stay).
RENAMES = {
    "tunnel_probe_before": "device_probe_before",
    "tunnel_probe_after": "device_probe_after",
    "tunnel_probes_per_run": "device_probes_per_run",
}
SMALL_DOCS, SMALL_QUERIES, SMALL_PASSES = 300, 16, 4


def _renamed(d):
    return {RENAMES.get(k, k): v for k, v in d.items()}


def _dumped_keys(path, func):
    """The constant keys of the dict literal that `func` in `path` passes to
    json.dumps."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps of a dict literal in {func}")


def _last_json(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]), len(lines)


# ---- the corpus helpers --------------------------------------------------


@pytest.mark.parametrize("num_docs,seed", [(5183, 0), (300, 0), (700, 3)])
def test_doclens_equal_jax(num_docs, seed):
    got = bench_torch.make_doclens(num_docs, seed=seed)
    want = bench.make_doclens(num_docs, seed=seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_queries,seed", [(320, 1), (16, 7)])
def test_queries_equal_jax(num_queries, seed):
    topics = np.random.default_rng(5).standard_normal((4096, 128)).astype(np.float32)
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)
    got = bench_torch.make_queries(topics, num_queries, seed=seed)
    want = bench.make_queries(topics, num_queries, seed=seed)
    assert len(got) == len(want) == num_queries
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (32, 128)
        np.testing.assert_array_equal(a, b)


def test_corpus_device_statistics():
    doclens = bench_torch.make_doclens(200)
    toks, topics = bench_torch.make_corpus_device(doclens, "cpu")
    assert toks.device.type == "cpu" and tuple(toks.shape) == (int(doclens.sum()), 128)
    assert topics.shape == (4096, 128) and isinstance(topics, np.ndarray)
    np.testing.assert_allclose(toks.norm(dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(topics, axis=1), 1.0, atol=1e-5)
    # The own topic is the nearest: noise of norm ~0.9 leaves ~0.74 cosine,
    # other random topics sit near 0 in 128 dims.
    cos = (toks.numpy() @ topics.T).max(axis=1)
    assert abs(float(cos.mean()) - 0.74) <= 0.05, float(cos.mean())
    again, _ = bench_torch.make_corpus_device(doclens, "cpu")
    assert bool((again == toks).all())  # made from the seed


# ---- the orchestrator ------------------------------------------------------


def _child(qps, build_s, recall, mfu_pct, w2, w6):
    return {
        "qps_p50": qps, "pipeline_window": 6 if w6 >= w2 else 2,
        "qps_p50_per_window": {"2": w2, "6": w6}, "qps_overall": qps * 0.9,
        "mfu_pct": mfu_pct, "recall_at_10_vs_f32_oracle": recall, "build_s": build_s,
        "num_docs": 5183, "num_embeddings": 1441163, "num_centroids": 16384, "nbits": 4,
        "queries": 320, "batch": 320, "passes": 12, "pin_dtype": "bf16",
        "pinned_token_grid": True,
        "tunnel_probe_before": {"rtt_ms": 0.05, "d2h_mbps": 9000.0 + qps},
        "tunnel_probe_after": {"rtt_ms": 0.06, "d2h_mbps": 9100.0 + qps},
    }


CHILDREN = [
    _child(21000.5, 9.87, 1.0, 3.71, 20500.25, 21000.5),
    _child(22100.0, float("nan"), 0.9984, 3.9, 22100.0, 21900.75),
    _child(20900.25, float("nan"), 0.9969, 3.68, 20100.0, 20900.25),
]


def _fake_run(lines, calls):
    """A stand-in for subprocess.run: the probe child succeeds; each bench
    child gets the next entry of `lines` (None: the child fails)."""
    queue = list(lines)

    def run(args, **kw):
        calls.append(args)
        if args[1:2] == ["-c"]:
            return subprocess.CompletedProcess(args, 0, "1\n", "")
        line = queue.pop(0)
        if line is None:
            return subprocess.CompletedProcess(args, 1, "", "Traceback: the child failed\n")
        return subprocess.CompletedProcess(args, 0, "a log line\n" + json.dumps(line) + "\n", "")

    return run


def _aggregate(monkeypatch, capsys, tmp_path, side, lines):
    monkeypatch.setenv("BENCH_IDX", str(tmp_path / "idx"))
    calls = []
    if side == "jax":
        monkeypatch.setattr(bench, "_device_reachable", lambda: True)
        monkeypatch.setattr(bench.time, "sleep", lambda s: None)
        monkeypatch.setattr(subprocess, "run", _fake_run(lines, calls))
        bench._orchestrate()
        code = 0
    else:
        ported = [None if ln is None else _renamed(ln) for ln in lines]
        monkeypatch.setattr(subprocess, "run", _fake_run(ported, calls))
        with pytest.raises(SystemExit) if None in lines else contextlib.nullcontext() as exit_:
            bench_torch._orchestrate()
        code = exit_.value.code if exit_ is not None else 0
    out, n_lines = _last_json(capsys)
    assert n_lines == 1
    return out, code, calls


def _same(a, b):
    """Equal JSON values, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("failed", [None, 1], ids=["all ok", "run 2 fails"])
def test_orchestrate_matches_jax(failed, monkeypatch, capsys, tmp_path):
    jax_lines = list(CHILDREN)
    port_lines = list(CHILDREN)
    if failed is not None:
        jax_lines[failed:failed + 1] = [None, None]  # bench.py retries once
        port_lines[failed] = None
    want, _, _ = _aggregate(monkeypatch, capsys, tmp_path, "jax", jax_lines)
    got, code, calls = _aggregate(monkeypatch, capsys, tmp_path, "port", port_lines)
    assert set(got) == set(want) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert got["detail"].keys() == _renamed(want["detail"]).keys()
    assert _same(got, dict(want, detail=_renamed(want["detail"]))), (got, want)
    for key in ("qps_p50_per_run", "cross_run_spread_pct", "mfu_pct", "index_build_s",
                "indexing_docs_per_s", "recall_at_10_vs_f32_oracle", "runs", "runs_failed"):
        assert _same(got["detail"][key], want["detail"][key]), key
    assert got["detail"]["runs_failed"] == (0 if failed is None else 1)
    assert code == (0 if failed is None else 1)
    # The probe, then three fresh children of this file with _BENCH_CHILD=1.
    assert calls[0][1] == "-c" and len(calls) == 4
    assert all(c[1] == os.path.abspath(bench_torch.__file__) for c in calls[1:])


def _recording_mkdtemp(monkeypatch, made):
    real = tempfile.mkdtemp

    def mkdtemp(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)


def test_orchestrate_removes_the_index_it_made(monkeypatch, capsys):
    """BENCH_IDX unset: the children share a temporary directory, which is
    gone after the last child; the children saw it as BENCH_IDX."""
    monkeypatch.delenv("BENCH_IDX", raising=False)
    made, envs = [], []
    _recording_mkdtemp(monkeypatch, made)
    fake = _fake_run([_renamed(c) for c in CHILDREN], [])

    def run(args, **kw):
        if "env" in kw:
            envs.append(kw["env"]["BENCH_IDX"])
            assert os.path.isdir(made[0])
        return fake(args, **kw)

    monkeypatch.setattr(subprocess, "run", run)
    bench_torch._orchestrate()
    line, _ = _last_json(capsys)
    assert line["detail"]["runs"] == 3 and len(made) == 1
    assert envs == [os.path.join(made[0], "scifact_scale")] * 3
    assert not os.path.exists(made[0])


@pytest.mark.parametrize("probe", ["no card", "timeout"])
def test_unreachable_device_is_an_outage(probe, monkeypatch, capsys):
    calls = []

    def run(args, **kw):
        calls.append(args)
        if probe == "timeout":
            raise subprocess.TimeoutExpired(args, kw["timeout"])
        return subprocess.CompletedProcess(args, 1, "", "no CUDA device")

    monkeypatch.setattr(subprocess, "run", run)
    with pytest.raises(SystemExit) as exit_:
        bench_torch._orchestrate()
    assert exit_.value.code == 1 and len(calls) == 1
    line, n_lines = _last_json(capsys)
    assert n_lines == 1 and line["value"] == 0.0 and "unreachable" in line["detail"]["error"]
    assert line.keys() == {"metric", "value", "unit", "vs_baseline", "detail"}


@pytest.mark.parametrize("e2e", [False, True], ids=["search", "composite"])
def test_script_fails_without_a_card(e2e, tmp_path):
    """`python bench_torch.py` on this box (no CUDA): one JSON line, exit 1,
    nothing measured on the CPU."""
    env = dict(os.environ, BENCH_IDX=str(tmp_path / "idx"), E2E_DOCS="48", E2E_QUERIES="8")
    env.pop("_BENCH_CHILD", None)
    env["BENCH_E2E"] = "1" if e2e else "0"
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] == 0.0 and line["metric"] == ("e2e_composite" if e2e else "search_qps")
    assert not (tmp_path / "idx").exists()
    if e2e:
        assert "CUDA is not available" in line["detail"]["error"]


# ---- run_once on a JAX-built index ------------------------------------------


@pytest.fixture(scope="module")
def jax_built(tmp_path_factory):
    """A BENCH_IDX built by the JAX package from the port's 300-doc corpus,
    and the corpus's topics."""
    doclens = bench_torch.make_doclens(SMALL_DOCS)
    toks, topics = bench_torch.make_corpus_device(doclens, "cpu")
    path = str(tmp_path_factory.mktemp("bench") / "scifact_scale")
    J.create_index_from_device(jnp.asarray(toks.numpy()), doclens, path,
                               J.IndexConfig(nbits=4, seed=42))
    return path, topics


@pytest.mark.parametrize("pin", ["bf16", "int8"])
def test_run_once_matches_jax_search(jax_built, pin, monkeypatch, capsys):
    path, topics = jax_built
    monkeypatch.setenv("BENCH_IDX", path)
    monkeypatch.setenv("BENCH_PIN_DTYPE", pin)
    record, results = bench_torch.run_once(device="cpu", num_docs=SMALL_DOCS,
                                           num_queries=SMALL_QUERIES, n_passes=SMALL_PASSES)
    line, n_lines = _last_json(capsys)
    assert n_lines == 1 and _same(line, record)
    assert set(record) == {RENAMES.get(k, k) for k in _dumped_keys(bench.__file__, "run_once")}
    assert (record["pin_dtype"], record["pinned_token_grid"]) == (pin, True)
    assert (record["num_docs"], record["queries"], record["batch"], record["passes"]) == (
        SMALL_DOCS, SMALL_QUERIES, SMALL_QUERIES, SMALL_PASSES)
    assert record["num_embeddings"] == int(bench_torch.make_doclens(SMALL_DOCS).sum())
    assert math.isnan(record["build_s"])  # the index came without build_seconds.json
    assert set(record["qps_p50_per_window"]) == {"2", "6"}
    for probe in ("device_probe_before", "device_probe_after"):
        assert record[probe].keys() == {"rtt_ms", "d2h_mbps"}
    assert record["recall_at_10_vs_f32_oracle"] >= (0.99 if pin == "bf16" else 0.95)

    ours = DeviceIndex.load(path, device="cpu").with_token_grid(dtype=pin)
    want_mfu = 100 * bench_torch.mfu(record["qps_p50"], 32, tuple(ours.token_grid.shape),
                                     pin == "int8")
    assert record["mfu_pct"] == pytest.approx(want_mfu, rel=1e-3, abs=0.01)

    queries = bench_torch.make_queries(topics, SMALL_QUERIES)
    ref = J.DeviceIndex.load(path).with_token_grid(dtype=pin)
    want = J.search_batch(ref, queries, J.SearchParameters(top_k=10, stage1_precision="default"))
    if pin == "bf16":
        _assert_same_topk(results, want)
    else:
        # The packages' int8 grids agree within one int8 step (ROADMAP
        # Queue 3), so scores agree to a step's share of a MaxSim sum.
        assert [len(r.passage_ids) for r in results] == [10] * SMALL_QUERIES
        overlap = np.mean([len(set(r.passage_ids) & set(w.passage_ids)) / 10
                           for r, w in zip(results, want)])
        assert overlap >= 0.95, overlap


def test_run_once_removes_the_index_it_built(monkeypatch, capsys):
    """run_once with BENCH_IDX unset builds its index in a temporary
    directory and removes it before it returns."""
    monkeypatch.delenv("BENCH_IDX", raising=False)
    monkeypatch.setenv("BENCH_PIN_DTYPE", "bf16")
    made = []
    _recording_mkdtemp(monkeypatch, made)
    record, results = bench_torch.run_once(device="cpu", num_docs=120, num_queries=4,
                                           n_passes=2, windows=(2,))
    assert len(made) == 1 and not os.path.exists(made[0])
    assert record["build_s"] > 0 and record["num_docs"] == 120
    assert set(record["qps_p50_per_window"]) == {"2"} and len(results) == 4


@pytest.mark.parametrize("shape,int8", [((5696, 304, 128), False), ((5760, 320, 128), True)],
                         ids=["bf16", "int8 doc-major"])
def test_mfu_counts_doc_major_slots(shape, int8):
    qps, tq = 21000.5, 32
    rows, td, d = shape
    peak = 1979e12 if int8 else 989e12
    want = qps * 2.0 * tq * d * rows * td / peak
    assert bench_torch.mfu(qps, tq, shape, int8) == pytest.approx(want, rel=1e-12)
    assert (bench_torch.PEAK_BF16_FLOPS, bench_torch.PEAK_INT8_OPS) == (989e12, 1979e12)


# ---- the composite -----------------------------------------------------------


def _load(path, name, monkeypatch):
    """The script at `path` as a fresh module, with E2E_DOCS 48 and
    E2E_QUERIES 8 (read when it is imported)."""
    monkeypatch.setenv("E2E_DOCS", "48")
    monkeypatch.setenv("E2E_QUERIES", "8")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def composites(monkeypatch):
    monkeypatch.setattr(jax_colbert, "os", os, raising=False)
    return (_load(COMPOSITE, "profile_torch_e2e_composite_t", monkeypatch),
            _load(JAX_COMPOSITE, "profile_e2e_composite_t", monkeypatch))


def test_composite_inputs_equal_jax(composites):
    ours, ref = composites
    tok, vocab = ours.make_wordpiece_tokenizer()
    jtok, jvocab = ref.make_wordpiece_tokenizer()
    assert vocab == jvocab
    docs, jdocs = ours.make_text_corpus(vocab), ref.make_text_corpus(jvocab)
    assert docs == jdocs and len(docs) == 48
    assert ours.make_excerpt_queries(docs) == ref.make_excerpt_queries(jdocs)
    queries, _ = ours.make_excerpt_queries(docs)
    assert len(queries) == 8
    enc, _ = ours.make_encoder("cpu")
    jenc, _ = ref.make_encoder()
    for texts, is_query in ((docs, False), (queries, True)):
        got, want = enc._prepare(texts, is_query), jenc._prepare(texts, is_query)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _tree(root):
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.stat(os.path.join(d, f)).st_mtime_ns)
                  for d, _, files in os.walk(root) for f in files)


def _record_api_searches(monkeypatch, client_cls):
    """Every search the composite sends through `client_cls`, as
    {query text: the API's top-10 (passage_ids, scores)}."""
    seen = {}
    search = client_cls.search

    def recording(self, name, queries, *args, **kwargs):
        out = search(self, name, queries, *args, **kwargs)
        for q, r in zip(queries, out["results"]):
            seen[q] = SimpleNamespace(passage_ids=list(r["document_ids"]),
                                      scores=list(r["scores"]))
        return out

    monkeypatch.setattr(client_cls, "search", recording)
    return seen


def test_composite_gate_and_keys_match_jax(composites, carried_kmeans, monkeypatch, capsys,
                                           tmp_path):
    """Both composites on the same texts and embeddings, the JAX weights and
    k-means carried across: each passes its own gate, the lines have the
    same keys, and the port's API top-10 equals the JAX composite's for
    every query (with _assert_same_topk's tie tolerance)."""
    ours, ref = composites
    import nextplaid_tpu.client as JC
    import nextplaid_tpu_torch.client as TC

    def carried(cfg, seed=0):
        jcfg = JM.BackboneConfig(**{k: getattr(cfg, k) for k in JM.BackboneConfig.__dataclass_fields__})
        return TM.params_from_jax(JM.init_random_params(jcfg, seed=seed))

    import nextplaid_tpu_torch.encoder as TE

    monkeypatch.setattr(TE, "init_random_params", carried)
    # Both forwards in float32 (as tests/test_torch_encoder.py's `_pair`),
    # and the JAX server given the port's document embeddings (as
    # tests/test_torch_codesearch.py's `_SharedDocuments`): the forwards
    # differ by ~5e-7, enough to move a token across a centroid or bucket
    # boundary, and so a score by ~1e-2. Queries are each package's own.
    make_ours, make_ref = ours.make_encoder, ref.make_encoder
    port_encoder = []

    def ours_f32(device=None):
        enc, vocab = make_ours(device)
        enc.model = TM.ColbertModel(enc.backbone_config, compute_dtype=torch.float32,
                                    device=device)
        enc.model.load_state_dict(carried(enc.backbone_config))
        port_encoder.append(enc)
        return enc, vocab

    def ref_f32():
        enc, vocab = make_ref()
        enc.model = JM.ColbertModel(enc.backbone_config, compute_dtype=jnp.float32)
        enc.encode_documents = port_encoder[0].encode_documents
        return enc, vocab

    monkeypatch.setattr(ours, "make_encoder", ours_f32)
    monkeypatch.setattr(ref, "make_encoder", ref_f32)
    got_api = _record_api_searches(monkeypatch, TC.NextPlaidClient)
    want_api = _record_api_searches(monkeypatch, JC.NextPlaidClient)
    benchmarks = os.path.join(ROOT, "docs", "benchmarks")
    before = _tree(benchmarks)
    ours.main(device="cpu")
    got, _ = _last_json(capsys)
    assert _tree(benchmarks) == before

    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if "cache" in k else update(k, v))
    real_mkdtemp = tempfile.mkdtemp

    def mkdtemp(*args, **kwargs):  # the JAX script leaves its index directory behind
        if kwargs.get("prefix") != "e2e_composite_":
            return real_mkdtemp(*args, **kwargs)
        os.makedirs(tmp_path / "jax_indices")
        return str(tmp_path / "jax_indices")

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    ref.main()
    want, _ = _last_json(capsys)

    assert got.keys() == want.keys() and got["detail"].keys() == want["detail"].keys()
    assert (got["metric"], got["unit"]) == (want["metric"], want["unit"]) == (
        "e2e_composite", "qps_with_encoding")
    for line in (got, want):
        assert line["detail"]["api_vs_library_top10_overlap"] >= 0.8
        assert (line["detail"]["n_docs"], line["detail"]["n_queries"]) == (48, 8)
        assert line["value"] > 0
    queries, _ = ours.make_excerpt_queries(ours.make_text_corpus(ours.make_wordpiece_tokenizer()[1]))
    assert set(got_api) == set(want_api) == set(queries)
    _assert_same_topk([got_api[q] for q in queries], [want_api[q] for q in queries])


# ---- no jax -------------------------------------------------------------------


def test_new_entry_points_load_no_jax():
    code = (
        "import runpy, sys\n"
        "sys.path.insert(0, 'scripts')\n"
        "import bench_torch, profile_torch_e2e_composite\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'nextplaid_tpu', "
        "'bench', 'profile_e2e_composite', 'bench_guard')]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
