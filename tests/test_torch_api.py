"""The port's REST service against the JAX package's, on the CPU.

Three parts:

1. The reference battery: `tests/test_api.py` and `tests/test_api_units.py`
   run against the port's server, models and state, loaded by
   `port_battery` with their imports of `nextplaid_tpu` pointed at
   `nextplaid_tpu_torch` and the port's entry points given device="cpu".
   Tests left out or adapted are listed beside `API_TESTS`.
2. Parity: the JAX server (aiohttp, as `tests/test_api.py` runs it) and the
   port's serve copies of one index directory; every request of
   `PARITY_REQUESTS` must get the same status code and the same JSON, search
   results compared as score-sorted top-k with a tie tolerance (scores within
   1e-4 relative) and their metadata equal. Ingest through `/update` and
   `/documents` on both leaves byte-identical index directories (the JAX
   k-means carried across), and `/encode` of the port's `Colbert` (f32, the
   JAX weights carried by `params_from_jax`) equals the JAX one within 1e-5.
3. The port's own behaviour: the in-place append of a served index, the
   kernels built at server start on a card, the refusal to start
   without one, and `api.inprocess.InProcessServer` (the server on a
   thread of the caller, as the harnesses run it). The sharded serve modes run through the reference's own
   tests (`test_sharded_serve_modes`, `test_sharded_staged_append_in_place`
   and `tests/test_device_append.py::test_api_ingest_uses_sharded_grid_append`),
   the service's mesh made eight CPU shards by the `cpu_mesh8` fixture, as
   the JAX tests' eight virtual CPU devices.
"""

import ast
import asyncio
import dataclasses
import os
import re
import shutil
import sys
import types

import numpy as np
import pytest
import requests
import torch
from _pytest.assertion.rewrite import rewrite_asserts

import nextplaid_tpu.encoder.colbert as jax_colbert
from nextplaid_tpu import index as J
from nextplaid_tpu.encoder import model as JM
from nextplaid_tpu_torch.api import state as port_state
from nextplaid_tpu_torch.encoder import model as TM
from nextplaid_tpu_torch.index import DeviceIndex
from nextplaid_tpu_torch.ops import maxsim_kernel
from tests.test_torch_update import _assert_same_dir, carried_kmeans  # noqa: F401 (fixture)

TESTS = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-4
ATOL = 1e-5


def jax_random_params(cfg, seed=0):
    """The JAX package's random weights for the port's BackboneConfig `cfg`,
    as the port's state_dict."""
    fields = {f.name for f in dataclasses.fields(JM.BackboneConfig)}
    jcfg = JM.BackboneConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})
    return TM.params_from_jax(JM.init_random_params(jcfg, seed=seed))


class _OnTheCpu(ast.NodeTransformer):
    """Adds device="cpu" to every call of one of `names` (the callee as
    written, e.g. "create_index" or "DeviceIndex.load") that names no device
    and passes no **kwargs."""

    def __init__(self, names):
        self.names = set(names)
        self.seen = set()

    def visit_Call(self, node):
        self.generic_visit(node)
        callee = ast.unparse(node.func)
        if callee in self.names and not any(
            kw.arg in ("device", None) for kw in node.keywords
        ):
            node.keywords.append(ast.keyword("device", ast.Constant("cpu")))
            self.seen.add(callee)
        return node


def port_battery(name, *edits, cpu_calls=()):
    """Load tests/<name>.py as a module whose imports of the JAX package
    name the port instead; then apply `edits`, (old, new) pairs of source
    text, each of which must occur, and give every call of `cpu_calls`
    (callees as written, each of which must occur) device="cpu". Its tests
    and fixtures are the reference file's own code, run against the port;
    `jax_random_params` is in its namespace."""
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as f:
        src = re.sub(r"\bnextplaid_tpu\b(?!_torch)", "nextplaid_tpu_torch", f.read())
    for old, new in edits:
        assert old in src, (name, old)
        src = src.replace(old, new)
    mod = types.ModuleType(f"tests.port_{name}")
    mod.__file__ = path
    mod.jax_random_params = jax_random_params
    sys.modules[mod.__name__] = mod
    tree = ast.parse(src, path)
    if cpu_calls:
        on_cpu = _OnTheCpu(cpu_calls)
        tree = ast.fix_missing_locations(on_cpu.visit(tree))
        assert on_cpu.seen == set(cpu_calls), (name, set(cpu_calls) - on_cpu.seen)
    rewrite_asserts(tree, src.encode(), path)  # pytest's failure messages
    exec(compile(tree, path, "exec"), mod.__dict__)
    return mod


def expose(mod, namespace, left_out=()):
    """Put the battery `mod`'s tests (but `left_out`) and fixtures into
    `namespace` (a test module's globals()), where pytest collects them.
    Returns the names of the tests put there."""
    from _pytest.fixtures import FixtureFunctionDefinition

    missing = set(left_out) - set(dir(mod))
    assert not missing, missing
    names = tuple(n for n in dir(mod) if n.startswith("test_") and n not in left_out)
    for n in dir(mod):
        if n in names or isinstance(getattr(mod, n), FixtureFunctionDefinition):
            namespace[n] = getattr(mod, n)
    return names


# The entry points of the port run on "cuda" unless given a device.
_api = port_battery(
    "test_api",
    ("build_app(self.index_dir, encoder=self.encoder)",
     "build_app(self.index_dir, encoder=self.encoder, device='cpu')"),
    # The encoder fixture builds the port's Colbert on the CPU, with the
    # JAX package's random weights (the tests' rankings are those weights').
    ("params=init_random_params(bcfg, seed=0), batch_size=4,",
     "params=jax_random_params(bcfg, seed=0), batch_size=4, device='cpu',"),
    # The ranking oracle stays the JAX package's f32 MaxSim on numpy arrays.
    ("from nextplaid_tpu_torch.ops.maxsim import maxsim_score",
     "from nextplaid_tpu.ops.maxsim import maxsim_score"),
    # The coalescing tests build their index and state with the port on
    # the CPU.
    ('create_index(docs, str(tmp_path / "coal"), IndexConfig(nbits=4, seed=0))',
     'create_index(docs, str(tmp_path / "coal"), IndexConfig(nbits=4, seed=0), device="cpu")'),
    ('create_index(docs, str(tmp_path / "coal2"), IndexConfig(nbits=4, seed=0))',
     'create_index(docs, str(tmp_path / "coal2"), IndexConfig(nbits=4, seed=0), device="cpu")'),
    ("st = state_mod.AppState(str(tmp_path))",
     "st = state_mod.AppState(str(tmp_path), device='cpu')", ),
    # The sharded serve modes shard over eight CPU shards.
    ("def test_sharded_serve_modes(server, mode):",
     "def test_sharded_serve_modes(server, mode, cpu_mesh8):"),
    ("def test_sharded_staged_append_in_place(server, monkeypatch):",
     "def test_sharded_staged_append_in_place(server, monkeypatch, cpu_mesh8):"),
)
_units = port_battery("test_api_units")
# Only its serve_mode=sharded_grid ingest test is the service's; the module's
# top-level `import jax.numpy` goes (the other tests, which use it, are the
# device append's, run against the port in tests/test_torch_append.py).
_device_append = port_battery(
    "test_device_append",
    ("import jax.numpy as jnp\n", ""),
    ('state = AppState(str(tmp_path / "apidx_sg"))',
     'state = AppState(str(tmp_path / "apidx_sg"), device="cpu")'),
    ("def test_api_ingest_uses_sharded_grid_append(tmp_path, monkeypatch):",
     "def test_api_ingest_uses_sharded_grid_append(tmp_path, monkeypatch, cpu_mesh8):"),
)
test_api_ingest_uses_sharded_grid_append = _device_append.test_api_ingest_uses_sharded_grid_append

ServerThread = _api.ServerThread
make_docs = _api.make_docs
doc_payload = _api.doc_payload
server = _api.server


@pytest.fixture
def cpu_mesh8(monkeypatch):
    """The service's sharded serve modes over eight CPU shards."""
    from nextplaid_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(port_state.AppState, "_mesh", lambda self: make_mesh(devices=["cpu"] * 8))
enc_server = _api.enc_server

# Every test of tests/test_api.py.
API_TESTS = (
    "test_health", "test_request_id_propagation", "test_index_lifecycle",
    "test_update_endpoint_sync", "test_max_documents_eviction",
    "test_encode_without_model", "test_errors", "test_concurrent_adds_coalesce",
    "test_encode_endpoint", "test_encode_coalescing_matches_solo",
    "test_encoding_ingest_and_search", "test_rerank_with_encoding",
    "test_metadata_failure_rolls_back_index", "test_openapi_spec",
    "test_search_with_request_subset", "test_swagger_ui_and_cors",
    "test_metadata_distinct", "test_delete_batching_coalesces",
    "test_grid_only_serve_mode", "test_bad_serve_mode_rejected",
    "test_search_coalescing_merges_and_slices",
    "test_search_coalescing_distinct_params_not_merged",
    "test_concurrent_searches_over_http", "test_bf16_wire_search",
    "test_sharded_serve_modes", "test_sharded_staged_append_in_place",
)
API_LEFT_OUT = ()
UNITS_TESTS = tuple(n for n in dir(_units) if n.startswith("test_"))
for _name in API_TESTS:
    globals()[_name] = getattr(_api, _name)
for _name in UNITS_TESTS:
    globals()[_name] = getattr(_units, _name)


def test_battery_lists_every_reference_test():
    reference = {n for n in dir(_api) if n.startswith("test_")}
    assert reference == set(API_TESTS) | set(API_LEFT_OUT)
    assert len(UNITS_TESTS) == 9


# ---------------------------------------------------------------------------
# Parity: the JAX server and the port's on copies of one index directory
# ---------------------------------------------------------------------------

DIM = 32
N_DOCS = 60
GROUPS = ("alpha", "beta", "gamma")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def parity_docs(n=N_DOCS, seed=0):
    """Clustered docs of 6-20 tokens over 8 topics."""
    rng = np.random.default_rng(seed)
    topics = _unit(rng.standard_normal((8, DIM)))
    return [
        _unit(topics[rng.integers(0, 8, k)] + 0.2 * rng.standard_normal((k, DIM)))
        for k in rng.integers(6, 21, n)
    ]


def parity_meta(ids):
    return [{"title": f"paper {i} on {GROUPS[i % 3]}", "group": GROUPS[i % 3], "year": 2000 + i % 7}
            for i in ids]


DOCS = parity_docs()
QUERIES = [DOCS[i][:5] for i in (3, 17, 41)]


def _b64(arrs):
    return [doc_payload(a, b64=True) for a in arrs]


_SEARCH = "/indices/idx/search"
# (id, method, path, JSON body or raw bytes).
PARITY_REQUESTS = [
    ("search-b64", "POST", _SEARCH, {"queries": _b64(QUERIES), "params": {"top_k": 5}}),
    ("search-json", "POST", _SEARCH,
     {"queries": [doc_payload(q) for q in QUERIES[:1]], "params": {"top_k": 7}}),
    ("search-exact-profile", "POST", _SEARCH,
     {"queries": _b64(QUERIES), "params": {"top_k": 5, "profile": "exact"}}),
    ("search-subset", "POST", _SEARCH,
     {"queries": _b64(QUERIES), "params": {"top_k": 4}, "subset": list(range(0, 60, 4))}),
    ("search-filter-condition", "POST", _SEARCH,
     {"queries": _b64(QUERIES), "params": {"top_k": 5},
      "filter_condition": '"group" = ?', "filter_parameters": ["beta"]}),
    ("search-filtered", "POST", "/indices/idx/search/filtered",
     {"queries": _b64(QUERIES[:2]), "params": {"top_k": 5},
      "filter_condition": "year >= ?", "filter_parameters": [2004]}),
    ("hybrid-relative-score", "POST", _SEARCH,
     {"queries": _b64(QUERIES), "text_query": ["alpha"], "params": {"top_k": 6}}),
    ("hybrid-rrf", "POST", _SEARCH,
     {"queries": _b64(QUERIES), "text_query": ["paper 17", "gamma", "beta"], "alpha": 0.6,
      "fusion": "rrf", "params": {"top_k": 6}}),
    ("keyword", "POST", _SEARCH, {"text_query": ["gamma"], "params": {"top_k": 8}}),
    ("list", "GET", "/indices", None),
    ("info", "GET", "/indices/idx", None),
    ("metadata-all", "GET", "/indices/idx/metadata", None),
    ("metadata-count", "GET", "/indices/idx/metadata/count", None),
    ("metadata-check", "POST", "/indices/idx/metadata/check", {"document_ids": [5, 500, 0]}),
    ("metadata-query", "POST", "/indices/idx/metadata/query",
     {"condition": '"group" = ? AND year < ?', "parameters": ["alpha", 2003]}),
    ("metadata-get", "POST", "/indices/idx/metadata/get",
     {"condition": "year = ?", "parameters": [2001], "limit": 4}),
    ("metadata-get-ids", "POST", "/indices/idx/metadata/get", {"document_ids": [9, 2, 33]}),
    ("metadata-distinct", "POST", "/indices/idx/metadata/distinct", {"column": "group"}),
    ("rerank", "POST", "/rerank",
     {"query": QUERIES[0].tolist(), "documents": _b64([DOCS[3], DOCS[4], DOCS[50]])}),
    ("rerank-b64", "POST", "/rerank",
     {"query_b64": _b64([QUERIES[1]])[0]["embeddings_b64"], "query_shape": list(QUERIES[1].shape),
      "documents": [doc_payload(DOCS[i]) for i in (16, 17, 18)]}),
    # Many documents of unequal lengths (6-20 tokens) scored in one batch.
    ("rerank-many-unequal", "POST", "/rerank",
     {"query": QUERIES[2].tolist(), "documents": _b64(DOCS[20:60])}),
    ("404-index", "GET", "/indices/missing", None),
    ("404-search", "POST", "/indices/missing/search", {"queries": _b64(QUERIES[:1])}),
    ("404-route", "GET", "/nothing/here", None),
    ("400-invalid-json", "POST", _SEARCH, b"{not json"),
    ("400-unknown-fusion", "POST", _SEARCH,
     {"queries": _b64(QUERIES[:1]), "text_query": ["alpha"], "fusion": "max"}),
    ("400-unknown-profile", "POST", _SEARCH,
     {"queries": _b64(QUERIES[:1]), "params": {"profile": "warp"}}),
    ("400-injection", "POST", "/indices/idx/metadata/query",
     {"condition": "year = ?; DROP TABLE METADATA", "parameters": [1]}),
    ("400-no-queries", "POST", _SEARCH, {"params": {"top_k": 3}}),
    ("400-distinct-no-column", "POST", "/indices/idx/metadata/distinct", {}),
    ("409-create-existing", "POST", "/indices", {"name": "idx"}),
    # A body over the limit: 413 where a handler reads the body itself, 400
    # where `_parse` turns the failed read into "invalid JSON body".
    ("413-body", "POST", "/indices/idx/metadata/distinct", b"[" + b"0," * 70_000 + b"0]"),
    ("400-body-over-limit", "POST", _SEARCH, b"[" + b"0," * 70_000 + b"0]"),
    ("422-missing-field", "POST", "/indices", {"bad": "payload"}),
    ("422-wrong-type", "POST", _SEARCH, {"queries": [{"embeddings": "text"}]}),
    ("503-encode", "POST", "/encode", {"texts": ["hi"], "input_type": "query"}),
]
# Small enough for the parity requests, small enough that "413-body" is over it.
PARITY_BODY_LIMIT = 100_000


def send(url, method, path, body):
    if isinstance(body, bytes):
        return requests.request(method, url + path, data=body,
                                headers={"Content-Type": "application/json"}, timeout=120)
    return requests.request(method, url + path, json=body, timeout=120)


def _assert_same_ranking(got, want):
    """Score-sorted top-k lists equal up to ties: scores within RTOL, and a
    doc in only one list scores within RTOL of the other list's last."""
    assert len(got["document_ids"]) == len(want["document_ids"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=RTOL, atol=ATOL)
    g_map = dict(zip(got["document_ids"], got["scores"]))
    w_map = dict(zip(want["document_ids"], want["scores"]))
    if want["scores"]:
        kth = want["scores"][-1]
        for doc in set(g_map) ^ set(w_map):
            score = g_map.get(doc, w_map.get(doc))
            assert abs(score - kth) <= ATOL + RTOL * abs(kth), (doc, score, kth)
    g_meta = dict(zip(got["document_ids"], got["metadata"]))
    w_meta = dict(zip(want["document_ids"], want["metadata"]))
    for doc in set(g_map) & set(w_map):
        assert g_meta[doc] == w_meta[doc]


def assert_same_json(got, want):
    """The port's body equals the JAX server's: search results by ranking,
    rerank scores within RTOL, everything else exactly."""
    if isinstance(want, dict) and "results" in want and "num_queries" in want:
        assert got["num_queries"] == want["num_queries"]
        for g, w in zip(got["results"], want["results"]):
            assert g["query_id"] == w["query_id"]
            _assert_same_ranking(g, w)
    elif isinstance(want, dict) and "results" in want:  # /rerank
        assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
        np.testing.assert_allclose([r["score"] for r in got["results"]],
                                   [r["score"] for r in want["results"]], rtol=RTOL, atol=ATOL)
    else:
        assert got == want


@pytest.fixture(scope="module")
def pair_servers(tmp_path_factory):
    """The JAX server and the port's, each on its copy of one JAX-built
    index (60 docs, metadata + FTS) and of its body limit."""
    from nextplaid_tpu.api import server as jax_server
    from nextplaid_tpu_torch.api import server as port_server
    from tests import test_api as jax_tests

    base = tmp_path_factory.mktemp("parity")
    src = str(base / "src" / "idx")
    J.create_index(DOCS, src, J.IndexConfig(nbits=4, seed=42))
    from nextplaid_tpu import filtering as JF
    from nextplaid_tpu.filtering import text_search as JT

    JF.create(src, parity_meta(range(N_DOCS)), list(range(N_DOCS)))
    JT.index(src, parity_meta(range(N_DOCS)), list(range(N_DOCS)))
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = str(base / side)
        shutil.copytree(src, os.path.join(dirs[side], "idx"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_server, "MAX_BODY_BYTES", PARITY_BODY_LIMIT)
        mp.setattr(port_server, "MAX_BODY_BYTES", PARITY_BODY_LIMIT)
        servers = {"jax": jax_tests.ServerThread(dirs["jax"]), "port": ServerThread(dirs["port"])}
    yield servers, dirs
    for s in servers.values():
        s.stop()


@pytest.mark.parametrize("case", PARITY_REQUESTS, ids=[c[0] for c in PARITY_REQUESTS])
def test_same_response(pair_servers, case):
    servers, _ = pair_servers
    _, method, path, body = case
    want = send(servers["jax"].url, method, path, body)
    got = send(servers["port"].url, method, path, body)
    assert got.status_code == want.status_code, (got.text, want.text)
    assert str(got.status_code) == case[0].split("-")[0] or got.status_code == 200
    if want.headers.get("Content-Type", "").startswith("application/json"):
        assert got.headers["Content-Type"].startswith("application/json")
        assert_same_json(got.json(), want.json())
    assert got.headers["Access-Control-Allow-Origin"] == want.headers["Access-Control-Allow-Origin"]


def test_same_health_and_openapi(pair_servers):
    servers, _ = pair_servers
    got, want = (requests.get(servers[s].url + "/health").json() for s in ("port", "jax"))
    volatile = {"version", "index_dir", "memory_usage_bytes"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in volatile} == {
        k: v for k, v in want.items() if k not in volatile
    }
    got, want = (requests.get(servers[s].url + "/api-docs/openapi.json").json()
                 for s in ("port", "jax"))
    assert got["paths"] == want["paths"]
    assert got["components"] == want["components"]
    import nextplaid_tpu_torch

    assert got["info"]["version"] == nextplaid_tpu_torch.__version__
    got, want = (requests.get(servers[s].url + "/swagger-ui") for s in ("port", "jax"))
    assert got.status_code == want.status_code == 200
    assert "/api-docs/openapi.json" in got.text


def test_request_id_and_preflight(pair_servers):
    servers, _ = pair_servers
    for s in servers.values():
        r = requests.get(s.url + "/indices", headers={"X-Request-ID": "trace-7"})
        assert r.headers["X-Request-ID"] == "trace-7"
        r = requests.options(s.url + "/indices/idx/search")
        assert r.status_code == 204 and r.headers["Access-Control-Allow-Headers"] == "*"



@pytest.mark.parametrize("config", [{}, {"start_from_scratch": 0}],
                         ids=["scratch-rebuilds", "buffer-appends"])
def test_ingest_leaves_identical_directories(pair_servers, carried_kmeans, config):
    """Create, `/update` (synchronous) then `/documents` (batched) with
    metadata, and a search in between so the served index takes the second
    batch: same responses, byte-identical directories (metadata rows
    equal). The default config rebuilds from scratch below 999 docs
    (k-means each time); start_from_scratch 0 appends in buffer mode (the
    port's served grid in place)."""
    servers, dirs = pair_servers
    name = "ing_" + ("buffer" if config else "scratch")
    docs = parity_docs(36, seed=9)
    steps = [
        ("POST", "/indices", {"name": name, "config": {"nbits": 4, "seed": 7, **config}}),
        ("POST", f"/indices/{name}/update",
         {"documents": _b64(docs[:24]), "metadata": parity_meta(range(24))}),
        ("POST", f"/indices/{name}/search", {"queries": _b64([docs[5][:4]]), "params": {"top_k": 3}}),
        ("POST", f"/indices/{name}/documents",
         {"documents": _b64(docs[24:]), "metadata": parity_meta(range(24, 36))}),
        ("POST", f"/indices/{name}/search",
         {"queries": _b64([docs[30][:4], docs[2][:4]]), "params": {"top_k": 3}}),
        ("GET", f"/indices/{name}", None),
    ]
    for method, path, body in steps:
        want = send(servers["jax"].url, method, path, body)
        got = send(servers["port"].url, method, path, body)
        assert got.status_code == want.status_code, (path, got.text, want.text)
        assert_same_json(got.json(), want.json())
    assert got.json()["num_documents"] == 36
    _assert_same_dir(os.path.join(dirs["jax"], name), os.path.join(dirs["port"], name))


@pytest.fixture(scope="module")
def encoder_servers(tmp_path_factory):
    """The JAX server and the port's with an encoder each: the JAX Colbert
    and the port's on the same weights (`params_from_jax`), both forwards in
    float32."""
    from tests import test_api as jax_tests
    from tests.test_torch_encoder import _pair
    from tests.test_encoder import make_tokenizer

    tok, vocab = make_tokenizer()
    with pytest.MonkeyPatch.context() as mp:
        # The JAX package's colbert.py uses `os` without importing it.
        mp.setattr(jax_colbert, "os", os, raising=False)
        jenc, tenc = _pair(tok, len(vocab), f32=True, mask_token_id=vocab["[MASK]"],
                           pad_token_id=vocab["[PAD]"])
        base = tmp_path_factory.mktemp("encoders")
        servers = {"jax": jax_tests.ServerThread(str(base / "jax"), jenc),
                   "port": ServerThread(str(base / "port"), tenc)}
        yield servers
    for s in servers.values():
        s.stop()


ENCODE_TEXTS = ["quick fox", "the quick brown fox jumps over the lazy dog", "a b c , d e",
                "lazy dog . dog"]


@pytest.mark.parametrize("body", [
    {"texts": ENCODE_TEXTS, "input_type": "document"},
    {"texts": ENCODE_TEXTS, "input_type": "query", "output_format": "base64"},
    {"texts": ENCODE_TEXTS, "input_type": "document", "pool_factor": 2,
     "output_format": "base64"},
], ids=["documents-json", "queries-base64", "documents-pooled-base64"])
def test_encode_matches_jax_server(encoder_servers, body):
    """`/encode` of the port's Colbert within 1e-5 of the JAX one (f32)."""
    got, want = (send(encoder_servers[s].url, "POST", "/encode", body).json()
                 for s in ("port", "jax"))
    assert got["num_texts"] == want["num_texts"] == len(ENCODE_TEXTS)
    if body.get("output_format") == "base64":
        assert got["shapes"] == want["shapes"] and got["embeddings"] is None
        from nextplaid_tpu_torch.api.models import decode_embeddings

        pairs = [(decode_embeddings(None, g, s), decode_embeddings(None, w, s))
                 for g, w, s in zip(got["embeddings_b64"], want["embeddings_b64"], got["shapes"])]
    else:
        pairs = [(np.asarray(g, np.float32), np.asarray(w, np.float32))
                 for g, w in zip(got["embeddings"], want["embeddings"])]
    for g, w in pairs:
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_encoding_endpoints_match_jax_server(encoder_servers):
    """`/rerank_with_encoding`, `/update_with_encoding` and
    `/search_with_encoding` give the JAX server's answers."""
    steps = [
        ("/rerank_with_encoding", {"query": "quick fox", "documents": ENCODE_TEXTS}),
        ("/indices/txt/update_with_encoding",
         {"documents": ENCODE_TEXTS * 3, "metadata": [{"n": i} for i in range(12)]}),
        ("/indices/txt/search_with_encoding",
         {"queries": ["quick brown fox", "lazy dog"], "params": {"top_k": 4}}),
        ("/indices/txt/search/filtered_with_encoding",
         {"queries": ["quick fox"], "params": {"top_k": 3}, "filter_condition": "n > ?",
          "filter_parameters": [5]}),
    ]
    for path, body in steps:
        want = send(encoder_servers["jax"].url, "POST", path, body)
        got = send(encoder_servers["port"].url, "POST", path, body)
        assert got.status_code == want.status_code == 200, (path, got.text, want.text)
        assert_same_json(got.json(), want.json())


# ---------------------------------------------------------------------------
# The port's own behaviour
# ---------------------------------------------------------------------------


def test_auto_serve_mode_appends_in_place(server, monkeypatch):
    """Adapts test_sharded_staged_append_in_place to the one-device serve
    mode the port has: a buffer-mode ingest into a served, pinned index
    advances it with `append_batch`, writing into the same grid tensor, and
    no reload runs. (The served copy loads with 12x headroom: the capacity
    rule wants 256 spare doc rows a batch, more than 32 docs' default 1.5x.)"""
    monkeypatch.setattr(port_state, "SERVE_CAPACITY_FACTOR", 12.0)
    name = "inplace"
    r = requests.post(server.url + "/indices",
                      json={"name": name, "config": {"nbits": 4, "start_from_scratch": 0}})
    assert r.status_code == 201, r.text
    docs = make_docs(32, seed=41)
    assert requests.post(server.url + f"/indices/{name}/update",
                         json={"documents": _b64(docs)}).status_code == 200
    q = docs[7][:6]
    r = requests.post(server.url + f"/indices/{name}/search",
                      json={"queries": _b64([q]), "params": {"top_k": 5}})
    assert r.json()["results"][0]["document_ids"][0] == 7

    loads, appended = [], []
    real_load, real_append = DeviceIndex.load.__func__, DeviceIndex.append_batch

    def counting_load(cls, *a, **kw):
        loads.append(a)
        return real_load(cls, *a, **kw)

    def recording_append(self, *a, **kw):
        out = real_append(self, *a, **kw)
        appended.append((self, out))
        return out

    monkeypatch.setattr(DeviceIndex, "load", classmethod(counting_load))
    monkeypatch.setattr(DeviceIndex, "append_batch", recording_append)
    more = make_docs(4, seed=42)
    r = requests.post(server.url + f"/indices/{name}/documents", json={"documents": _b64(more)})
    assert r.status_code == 202, r.text
    assert loads == [] and len(appended) == 1
    before, after = appended[0]
    assert before.token_grid is not None and after is not None
    assert after.token_grid.data_ptr() == before.token_grid.data_ptr()
    assert (after.num_documents, before.num_documents) == (36, 32)
    for doc_id, q2 in ((34, more[2][:6]), (7, q)):
        r = requests.post(server.url + f"/indices/{name}/search",
                          json={"queries": _b64([q2]), "params": {"top_k": 5}})
        assert r.json()["results"][0]["document_ids"][0] == doc_id


def test_kernels_load_before_requests_on_a_card(tmp_path, monkeypatch):
    """On a card the app builds and loads the served kernels while it
    starts, before it takes a request; on the CPU it builds nothing. (A
    "cuda" device object needs no card until something is allocated.)"""
    from aiohttp import web

    from nextplaid_tpu_torch.api.server import build_app

    loads = []
    monkeypatch.setattr(maxsim_kernel, "load_kernels", lambda: loads.append(1))

    async def start_and_stop(device):
        runner = web.AppRunner(build_app(str(tmp_path), device=device))
        await runner.setup()
        await runner.cleanup()

    asyncio.run(start_and_stop("cpu"))
    assert loads == []
    asyncio.run(start_and_stop("cuda"))
    assert loads == [1]


def test_without_device_raises(tmp_path, monkeypatch):
    """The server's entry points take "cuda" when no device is named, and
    refuse to start without a card instead of serving from the CPU."""
    from nextplaid_tpu_torch.api.server import build_app, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_app(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_state.AppState(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--index-dir", str(tmp_path), "--port", "0"])


def test_stopped_server_releases_its_state(tmp_path):
    """aiohttp keeps each Application it has built middleware for in a
    module-level cache, so a stopped server's state outlives it. The app's
    cleanup drops the state's loaded indexes and encoder pool: the served
    index (device memory on a card) is freed once the caller lets go."""
    import gc
    import weakref

    from nextplaid_tpu_torch.api.inprocess import InProcessServer
    from nextplaid_tpu_torch.client import NextPlaidClient
    from nextplaid_tpu_torch.index import IndexConfig, create_index

    docs = parity_docs(20)
    create_index(docs, str(tmp_path / "idx"), IndexConfig(nbits=2), device="cpu")
    server = InProcessServer(str(tmp_path), device="cpu")
    try:
        NextPlaidClient(server.url).search("idx", [docs[3]], top_k=3)
        served = weakref.ref(server.state.served("idx"))
        assert served() is not None
    finally:
        server.stop()
    state = server.state
    del server
    gc.collect()
    assert served() is None
    assert state.served("idx") is None and state.encoder_pool is None


def test_in_process_server_serves_and_stops(tmp_path):
    """`InProcessServer` answers through the SDK on the device it is given,
    and `stop()` ends its thread; a server that cannot start raises."""
    from nextplaid_tpu_torch.api.inprocess import InProcessServer
    from nextplaid_tpu_torch.client import NextPlaidClient

    server = InProcessServer(str(tmp_path), device="cpu")
    try:
        client = NextPlaidClient(server.url)
        assert client.health()["status"] == "ok"
        client.create_index("idx", config={"nbits": 2})
        assert client.list_indices() == ["idx"]
        assert server.state.device == torch.device("cpu")
    finally:
        server.stop()
    assert not server.thread.is_alive()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            InProcessServer(str(tmp_path))
