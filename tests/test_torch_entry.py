"""The port's entry points (`nextplaid_tpu_torch.entry`) against the JAX
package's `__graft_entry__.py`, on the CPU.

- `entry()`: the staged step of each package over the same 64-doc index (the
  JAX k-means carried into the port's build by `carried_kmeans`, so the two
  index directories are byte-identical), run as `fn(*args)` on the port's
  side and as `jax.jit(fn)(*args)` on the JAX side: top-5 ids as
  score-sorted sets under `_assert_same_topk`'s tie rule, scores within
  1e-4. At the default centroid_score_threshold of 0.4 the example queries
  (random unit rows in d 128) select no cell in either package, so both
  steps return no hit; the step is also compared with the threshold off.
  The port's step equals the port's `search_batch` on the same parameters.
- `dryrun_multichip(8, device="cpu")` prints the same `DRYRUN VERIFIED:`
  line as the JAX dry run on the JAX package's eight virtual CPU devices,
  every flag True; `python -m nextplaid_tpu_torch.entry` runs both steps;
  `grid_out` hands back the dry run's sharded int8 grid and its queries.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nextplaid_tpu_torch import entry as E
from nextplaid_tpu_torch.index import QueryResult, SearchParameters, search_batch
from tests.test_torch_search import _assert_same_topk
from tests.test_torch_update import _assert_same_dir, carried_kmeans  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _results(ids, scores):
    ids, scores = np.asarray(ids), np.asarray(scores)
    return [QueryResult(i, [int(x) for x in row[row >= 0]], [float(s) for s in srow[row >= 0]])
            for i, (row, srow) in enumerate(zip(ids, scores))]


def _assert_same_hits(got, want, k):
    """k = 0: no hit on either side; else `_assert_same_topk` at k."""
    if k:
        _assert_same_topk(got, want, k=k)
    else:
        assert len(got) == len(want) and all(not r.passage_ids for r in got + want)


def _without_threshold(fn):
    shapes = dataclasses.replace(fn.keywords["shapes"], threshold=None)
    return lambda *a: fn.func(*a, **dict(fn.keywords, shapes=shapes))


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = graft.entry()
    return fn, args, args[0]._graft_path


@pytest.mark.parametrize("threshold", ["default", "off"])
def test_entry_matches_jax(jax_entry, carried_kmeans, tmp_path, threshold):
    jfn, jargs, jpath = jax_entry
    fn, args = E.entry(device="cpu", path=str(tmp_path / "idx"))
    _assert_same_dir(str(tmp_path / "idx"), jpath)
    if threshold == "off":
        fn, jfn = _without_threshold(fn), _without_threshold(jfn)
    ids, scores, overflow = fn(*args)
    jids, jscores, joverflow = jax.jit(jfn)(*jargs)
    assert ids.shape == scores.shape == (8, 5) and overflow.shape == (8,)
    k = 0 if threshold == "default" else 5
    got, want = _results(ids, scores), _results(jids, jscores)
    _assert_same_hits(got, want, k)
    if k:
        np.testing.assert_allclose([r.scores for r in got], [r.scores for r in want],
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(joverflow))


@pytest.mark.parametrize("threshold", [0.4, None])
def test_entry_matches_search_batch(tmp_path, threshold):
    fn, args = E.entry(device="cpu", path=str(tmp_path / "idx"))
    if threshold is None:
        fn = _without_threshold(fn)
    index, queries, qmask = args
    ids, scores, _ = fn(*args)
    valid = [q[m].numpy() for q, m in zip(queries, qmask)]
    want = search_batch(index, valid, SearchParameters(
        top_k=5, n_full_scores=64, mode="staged", centroid_score_threshold=threshold))
    _assert_same_hits(_results(ids, scores), want, 0 if threshold else 5)


def _jax_summary_keys():
    with open(os.path.join(ROOT, "__graft_entry__.py")) as f:
        src = f.read()
    block = src[src.index("summary = (") : src.index("print(summary")]
    return re.findall(r'f"(?:DRYRUN VERIFIED: )?(.+?)=(?:\{|True)', block)


def test_dryrun_multichip_prints_the_jax_line(capsys, monkeypatch):
    summary = E.dryrun_multichip(8, device="cpu")
    out, err = capsys.readouterr()
    assert summary in out.splitlines() and summary in err.splitlines()
    fields = dict(re.findall(r"(\S+)=(\[[^\]]*\]|True|False|\d+)", summary))
    assert list(fields) == _jax_summary_keys()
    assert all(v == "True" for k, v in fields.items() if not k.endswith(("shards", "devices")))
    # The JAX dry run in this process, on its eight virtual CPU devices.
    monkeypatch.setenv("_GRAFT_DRYRUN_CHILD", "1")
    graft.dryrun_multichip(8)
    jout, _ = capsys.readouterr()
    assert summary in jout.splitlines()


def test_dryrun_hands_back_its_int8_grid():
    """`grid_out` receives the dry run's sharded int8 grids and the queries
    of its grid search, whose kernel scores a smoke run holds against the
    plain version."""
    from nextplaid_tpu_torch.parallel.sharded import shard_grid_scores
    from nextplaid_tpu_torch.index.search import _pad_queries

    out = {}
    E.dryrun_multichip(2, device="cpu", grid_out=out)
    sg, queries = out["sg"], out["queries"]
    assert sg.is_int8 and sg.n_shards == 2 and len(sg.grids) == 2
    assert [q.shape for q in queries] == [(6, 32)] * 4
    q = torch.from_numpy(_pad_queries(queries, sg.dim)[0])
    scores = [shard_grid_scores(sg, i, q) for i in range(2)]
    assert all(s.shape == (4, sg.rows) and torch.isfinite(s).all() for s in scores)


def test_entry_cli_runs_both_steps():
    out = subprocess.run(
        [sys.executable, "-m", "nextplaid_tpu_torch.entry", "--device", "cpu", "--shards", "4"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "entry OK: [(8, 5), (8, 5), (8,)]"
    verified = [ln for ln in lines if ln.startswith("DRYRUN VERIFIED: devices=4 ")]
    assert verified and verified[0] in out.stderr
    assert lines[-1] == "dryrun_multichip OK"


def test_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.dryrun_multichip(2)
