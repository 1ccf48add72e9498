"""The port's code search (`nextplaid_tpu_torch.codesearch`, the `cgrep`
CLI) against the JAX package's, on the CPU.

1. The reference batteries, loaded by `port_battery` with `nextplaid_tpu`
   pointed at `nextplaid_tpu_torch`:
   - `tests/test_codesearch.py`, all 16 tests. Edits: the `encoder`
     fixture's port `Colbert` takes the JAX package's random weights
     (`jax_random_params`) and device="cpu"; `ProjectIndexer` and `Searcher`
     get device="cpu"; the CLI runs get `--device cpu`, and the
     monkeypatched `_load_encoder` accepts the port's `device` argument.
     None is adapted or left out. (Against the JAX package five of them fail
     on the `os` NameError of its encoder; the port's `Colbert` imports
     `os`.)
   - `tests/test_structparse.py` and `tests/test_cgrep_config.py`, every
     test, without edits.
2. Unit parity: `extract_units` of both packages over the repo's own
   `nextplaid_tpu/`, `native/` and `tests/` trees gives equal units, field
   by field, and equal `build_embedding_text`.
3. Index and hit parity: both packages' `ProjectIndexer` over
   test_codesearch.py's two projects, with float32 encoders on the same
   weights on both sides (`params_from_jax`; `os` patched into the JAX
   `Colbert` module), the port's document embeddings given to both indexers
   (see `_SharedDocuments`) and the JAX k-means carried across: the same
   `state.json` doc ids and hashes and the same metadata rows; the same hits
   (file, name and line equal, scores within 1e-4) for queries under the
   path, glob, regex and no-rank-boosts options; the same after an
   incremental update that edits one file and deletes another; the same
   `--json` CLI output.
"""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import nextplaid_tpu.codesearch as JC
import nextplaid_tpu.encoder.colbert as jax_colbert
from nextplaid_tpu import filtering as jax_filtering
from nextplaid_tpu.codesearch import cli as jax_cli
from nextplaid_tpu.encoder import model as JM
import nextplaid_tpu_torch.codesearch as TC
from nextplaid_tpu_torch import filtering as torch_filtering
from nextplaid_tpu_torch.codesearch import cli as torch_cli
from nextplaid_tpu_torch.encoder import Colbert, ColbertConfig
from nextplaid_tpu_torch.encoder import model as TM
from tests.test_torch_api import port_battery
from tests.test_torch_update import carried_kmeans  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-4

# ---------------------------------------------------------------------------
# 1. The reference batteries
# ---------------------------------------------------------------------------

_cs = port_battery(
    "test_codesearch",
    ("params=init_random_params(bcfg, seed=0), batch_size=8,",
     "params=jax_random_params(bcfg, seed=0), batch_size=8, device='cpu',"),
    ("index_dir=idx_dir, batch_size=16", "index_dir=idx_dir, batch_size=16, device='cpu'"),
    ("Searcher(str(indexed.index_dir), encoder)",
     "Searcher(str(indexed.index_dir), encoder, device='cpu')"),
    ("Searcher(str(indexer.index_dir), encoder)",
     "Searcher(str(indexer.index_dir), encoder, device='cpu')"),
    ("lambda model, batch_size=16: indexed.encoder",
     "lambda model, batch_size=16, device=None: indexed.encoder"),
    ('["--path", str(indexed.project),', '["--device", "cpu", "--path", str(indexed.project),'),
)
_sp = port_battery("test_structparse")
_cfg = port_battery("test_cgrep_config")

CS_TESTS = tuple(n for n in dir(_cs) if n.startswith("test_"))
SP_TESTS = tuple(n for n in dir(_sp) if n.startswith("test_"))
CFG_TESTS = tuple(n for n in dir(_cfg) if n.startswith("test_"))
for _mod, _names in ((_cs, CS_TESTS), (_sp, SP_TESTS), (_cfg, CFG_TESTS)):
    for _name in _names:
        globals()[_name] = getattr(_mod, _name)
project = _cs.project
polyglot_project = _cs.polyglot_project
encoder = _cs.encoder
indexed = _cs.indexed
cfg_dir = _cfg.cfg_dir


def test_batteries_run_every_reference_test():
    assert len(CS_TESTS) == 16
    assert len(SP_TESTS) == len([n for n in dir(_sp) if n.startswith("test_")]) > 0
    assert len(CFG_TESTS) == len([n for n in dir(_cfg) if n.startswith("test_")]) > 0


# ---------------------------------------------------------------------------
# 2. Unit parity over the repo's own trees
# ---------------------------------------------------------------------------


def _tree_files(tree):
    out = []
    for root, dirs, files in os.walk(ROOT / tree):
        dirs[:] = sorted(d for d in dirs if d not in JC.indexer.SKIP_DIRS
                         and not d.startswith("."))
        out.extend(Path(root) / f for f in sorted(files)
                   if JC.detect_language(Path(root) / f) is not None)
    return out


@pytest.mark.parametrize("tree", ["nextplaid_tpu", "native", "tests"])
def test_extract_units_match_jax(tree):
    files = _tree_files(tree)
    assert files
    n_units = 0
    for path in files:
        ours, ref = TC.extract_units(path), JC.extract_units(path)
        assert [u.to_dict() for u in ours] == [u.to_dict() for u in ref], path
        assert ([TC.build_embedding_text(u) for u in ours]
                == [JC.build_embedding_text(u) for u in ref]), path
        n_units += len(ours)
    assert n_units > len(files) // 2


# ---------------------------------------------------------------------------
# 3. Index and hit parity
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def jax_colbert_os(monkeypatch):
    """The JAX package's colbert.py uses `os` without importing it."""
    monkeypatch.setattr(jax_colbert, "os", os, raising=False)


@pytest.fixture(scope="module")
def encoders():
    """The JAX package's and the port's Colbert on test_codesearch.py's
    tokenizer, config and random weights, both forwards in float32."""
    ported = _cs.encoder.__wrapped__()
    tok, cfg = ported.tokenizer, ported.config
    bcfg = dataclasses.asdict(ported.backbone_config)
    jbcfg = JM.BackboneConfig(**{f.name: bcfg[f.name]
                                 for f in dataclasses.fields(JM.BackboneConfig)})
    params = JM.init_random_params(jbcfg, seed=0)
    jcfg = jax_colbert.ColbertConfig(**dataclasses.asdict(cfg))
    jenc = jax_colbert.Colbert(config=jcfg, backbone_config=jbcfg, tokenizer=tok,
                               params=params, batch_size=8)
    jenc.model = JM.ColbertModel(jenc.backbone_config, compute_dtype=jnp.float32)
    tenc = Colbert(config=ColbertConfig(**dataclasses.asdict(cfg)),
                   backbone_config=TM.BackboneConfig(**bcfg), tokenizer=tok,
                   params=TM.params_from_jax(params), batch_size=8, device="cpu")
    tenc.model = TM.ColbertModel(tenc.backbone_config, compute_dtype=torch.float32,
                                 device="cpu")
    tenc.model.load_state_dict(TM.params_from_jax(params))
    return _SharedDocuments(jenc, tenc), tenc


class _SharedDocuments:
    """The JAX package's encoder, but for documents the port's embeddings.
    The two float32 forwards differ by ~1e-7, and a token that close to a
    centroid or bucket boundary is compressed to another code: the indexes
    would differ by a residual step (scores by ~1e-3). With the same
    document embeddings (and the JAX k-means carried across) both packages
    build the same index, so hits compare at 1e-4; queries are each
    package's own."""

    def __init__(self, jax_encoder, port_encoder):
        self.jax_encoder, self.port_encoder = jax_encoder, port_encoder

    def encode_documents(self, texts, **kw):
        return self.port_encoder.encode_documents(texts, **kw)

    def encode_queries(self, queries):
        return self.jax_encoder.encode_queries(queries)


def _copy_project(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.fixture
def pair(encoders, carried_kmeans, tmp_path, request):
    """Both packages' indexers over one copy of a test_codesearch.py project
    (`request.param`: "project" or "polyglot_project")."""
    src = request.getfixturevalue(request.param)
    proj = _copy_project(src, tmp_path / "proj")
    jenc, tenc = encoders
    ji = JC.ProjectIndexer(str(proj), jenc, index_dir=str(tmp_path / "jax"), batch_size=16)
    ti = TC.ProjectIndexer(str(proj), tenc, index_dir=str(tmp_path / "torch"), batch_size=16,
                           device="cpu")
    assert ji.update() == ti.update()
    return proj, ji, ti


def _assert_same_state(ji, ti):
    js, ts = ji.state["files"], ti.state["files"]
    assert sorted(js) == sorted(ts)
    for rel in js:
        assert (js[rel]["doc_ids"], js[rel]["hash"]) == (ts[rel]["doc_ids"], ts[rel]["hash"]), rel
    assert (jax_filtering.get(str(ji.index_dir))
            == torch_filtering.get(str(ti.index_dir)))
    assert ji.status()["units"] == ti.status()["units"]


def _assert_same_hits(got, want):
    assert [(h.file, h.name, h.line, h.end_line, h.unit_type) for h in got] == [
        (h.file, h.name, h.line, h.end_line, h.unit_type) for h in want]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want],
                               rtol=0, atol=SCORE_TOL)


QUERIES = {
    "plain": ("authenticate user password", {}),
    "path": ("payment gateway charge", dict(path_prefix="src")),
    "glob": ("payment gateway charge", dict(include_globs=["payments.py"])),
    "exclude": ("auth", dict(exclude_dirs=["tests"], exclude_globs=["*notify*"])),
    "regex": ("anything", dict(regex=r"gateway_call\(")),
    "regex_path": ("user", dict(regex=r"return", path_prefix="src")),
    "no_rank_boosts": ("load user record", dict(no_rank_boosts=True, top_k=5)),
    "poly": ("compute vector length euclidean norm", {}),
}


def _search_both(ji, ti, name):
    query, opts = QUERIES[name]
    jenc, tenc = ji.encoder, ti.encoder
    got = TC.Searcher(str(ti.index_dir), tenc, device="cpu").search(query, TC.SearchOptions(**opts))
    want = JC.Searcher(str(ji.index_dir), jenc).search(query, JC.SearchOptions(**opts))
    return got, want


@pytest.mark.parametrize("pair", ["project", "polyglot_project"], indirect=True)
def test_index_state_matches_jax(pair):
    _, ji, ti = pair
    _assert_same_state(ji, ti)


@pytest.mark.parametrize("pair", ["project"], indirect=True)
def test_hits_match_jax(pair):
    _, ji, ti = pair
    for name in QUERIES:
        got, want = _search_both(ji, ti, name)
        _assert_same_hits(got, want)


@pytest.mark.parametrize("pair", ["polyglot_project"], indirect=True)
def test_polyglot_hits_match_jax(pair):
    _, ji, ti = pair
    for name in ("poly", "plain", "no_rank_boosts"):
        got, want = _search_both(ji, ti, name)
        assert got
        _assert_same_hits(got, want)


@pytest.mark.parametrize("pair", ["project"], indirect=True)
def test_incremental_update_matches_jax(pair):
    """Edit one file, add one, delete another; both indexers re-index the
    same files, resequence the same doc ids and answer the same hits."""
    proj, ji, ti = pair
    (proj / "src" / "auth.py").write_text(
        (proj / "src" / "auth.py").read_text()
        + '\n\ndef rotate_token(user):\n    """Issue a fresh session token."""\n'
        "    return user\n")
    (proj / "src" / "notify.py").write_text(
        'def send_email(to, body):\n    """Send a notification email."""\n    return True\n')
    (proj / "tests" / "test_auth.py").unlink()
    stats = ti.update()
    assert stats == ji.update()
    assert (stats["changed"], stats["deleted"]) == (2, 1)
    _assert_same_state(ji, ti)
    for name in QUERIES:
        got, want = _search_both(ji, ti, name)
        _assert_same_hits(got, want)
    got = TC.Searcher(str(ti.index_dir), ti.encoder, device="cpu").search(
        "rotate_token", TC.SearchOptions(top_k=3))
    assert any(h.name == "rotate_token" for h in got)


@pytest.mark.parametrize("pair", ["project"], indirect=True)
def test_cli_json_matches_jax(pair, monkeypatch):
    proj, ji, ti = pair
    monkeypatch.setattr(jax_cli, "_load_encoder", lambda model, batch_size=16: ji.encoder)
    monkeypatch.setattr(torch_cli, "_load_encoder",
                        lambda model, batch_size=16, device=None: ti.encoder)
    runner = CliRunner()
    for args in (["authenticate user"], ["-e", "gateway_call", "payment"],
                 ["--include", "*.py", "--no-rank-boosts", "load user"]):
        base = ["--path", str(proj), "--no-update", "--json"]
        out_t = runner.invoke(torch_cli.cli, ["--device", "cpu", *base, "--index-dir",
                                              str(ti.index_dir), *args], obj={},
                              catch_exceptions=False)
        out_j = runner.invoke(jax_cli.cli, [*base, "--index-dir", str(ji.index_dir), *args],
                              obj={}, catch_exceptions=False)
        assert out_t.exit_code == out_j.exit_code == 0, (out_t.output, out_j.output)
        got, want = json.loads(out_t.output), json.loads(out_j.output)
        assert got and len(got) == len(want)
        for g, w in zip(got, want):
            assert abs(g.pop("score") - w.pop("score")) <= SCORE_TOL
            assert g == w


def test_entry_points_need_a_device_without_a_card(encoders, tmp_path, monkeypatch):
    """Given no device the indexer, the searcher and the CLI take "cuda",
    and raise without a card (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tenc = encoders
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.ProjectIndexer(str(tmp_path), tenc, index_dir=str(tmp_path / "idx"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.Searcher(str(tmp_path / "idx"), tenc)
    result = CliRunner().invoke(torch_cli.cli, ["--path", str(tmp_path), "--model",
                                                str(tmp_path), "query"], obj={})
    assert result.exit_code != 0
    assert "CUDA is not available" in str(result.exception)


def test_cache_root_is_the_ports(monkeypatch, tmp_path):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert TC.indexer.cache_root() == tmp_path / "nextplaid_tpu_torch" / "codesearch"
    assert JC.indexer.cache_root() == tmp_path / "nextplaid_tpu" / "codesearch"
