"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points do not fall back to the CPU when no device is named."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nextplaid_tpu_torch
from nextplaid_tpu_torch.index import DeviceIndex, IndexConfig, create_index
from nextplaid_tpu_torch.index.build import create_index_from_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.dirname(nextplaid_tpu_torch.__file__)
GOLDEN = os.path.join(ROOT, "tests", "golden", "index_nbits4")
FORBIDDEN = ("jax", "flax", "nextplaid_tpu")
CODESEARCH_MODULES = ("cli", "config", "display", "embed", "indexer", "install", "parser",
                      "ranking", "searcher", "structparse", "types", "webformats")


SCRIPTS = sorted(glob.glob(os.path.join(ROOT, "scripts", "*torch*.py")))
# The entry points of the eleventh slice, each run with --help below.
ENTRY_SCRIPTS = ("eval_torch_beir.py", "fetch_torch_eval_assets.py", "eval_torch_codesearch.py",
                 "eval_torch_recall.py", "run_torch_stress_acceptance.py")


def _sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "bench_torch.py")
    yield from SCRIPTS


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_import_leaves_jax_out():
    code = (
        "import sys, nextplaid_tpu_torch, nextplaid_tpu_torch.index, "
        "nextplaid_tpu_torch.ops, nextplaid_tpu_torch.ops.maxsim_kernel, "
        "nextplaid_tpu_torch.ops.maxsim_variants, nextplaid_tpu_torch.index.search, "
        "nextplaid_tpu_torch.filtering, nextplaid_tpu_torch.filtering.text_search, "
        "nextplaid_tpu_torch.index.update, nextplaid_tpu_torch.index.delete, "
        "nextplaid_tpu_torch.index.embeddings, nextplaid_tpu_torch.encoder, "
        "nextplaid_tpu_torch.encoder.hub, nextplaid_tpu_torch.storage, "
        "nextplaid_tpu_torch.storage.native, nextplaid_tpu_torch.storage.merge_cache, "
        "nextplaid_tpu_torch.storage.convert, nextplaid_tpu_torch.api, "
        "nextplaid_tpu_torch.api.server, nextplaid_tpu_torch.api.encode_pool, "
        "nextplaid_tpu_torch.client, nextplaid_tpu_torch.client.cli, "
        "nextplaid_tpu_torch.eval, nextplaid_tpu_torch.scripts_export, "
        "nextplaid_tpu_torch.ops.rq, nextplaid_tpu_torch.codesearch, "
        "nextplaid_tpu_torch.parallel, nextplaid_tpu_torch.parallel.mesh, "
        "nextplaid_tpu_torch.parallel.sharded, nextplaid_tpu_torch.entry, "
        + ", ".join(f"nextplaid_tpu_torch.codesearch.{m}" for m in CODESEARCH_MODULES)
        + "\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'nextplaid_tpu') or "
        "m.startswith(('jax.', 'flax.', 'nextplaid_tpu.'))]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", list(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_no_jax(path):
    for module in _imported_roots(path):
        root = module.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {module}"


# Runs `target` as __main__ with --help, jax, flax and the JAX package made
# unimportable (a None entry in sys.modules makes `import` raise).
_HELP_WITHOUT_JAX = (
    "import runpy, sys\n"
    "sys.modules.update(jax=None, flax=None, nextplaid_tpu=None)\n"
    "kind, target = sys.argv[1:3]\n"
    "sys.argv = [target, '--help']\n"
    "run = runpy.run_path if kind == 'path' else runpy.run_module\n"
    "run(target, run_name='__main__')\n"
)


@pytest.mark.parametrize("target", [("module", "nextplaid_tpu_torch.entry")] + [
    ("path", os.path.join("scripts", name)) for name in ENTRY_SCRIPTS], ids=lambda t: t[1])
def test_entry_points_help_without_jax(target):
    assert set(ENTRY_SCRIPTS) <= {os.path.basename(p) for p in SCRIPTS}
    out = subprocess.run([sys.executable, "-c", _HELP_WITHOUT_JAX, *target],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_load_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIndex.load(GOLDEN)
    assert DeviceIndex.load(GOLDEN, device="cpu").num_documents > 0


def test_build_without_device_raises(no_cuda, tmp_path):
    docs = [np.eye(4, 8, dtype=np.float32)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_index(docs, str(tmp_path / "a"), IndexConfig(nbits=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_index_from_device(torch.from_numpy(docs[0]), [4], str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_index(docs, str(tmp_path / "c"), IndexConfig(nbits=2, centroid_structure="rq"))


def test_update_without_device_raises(no_cuda, tmp_path):
    from nextplaid_tpu_torch.index.update import (
        UpdateConfig, find_outliers, update, update_or_create_with_metadata,
    )

    docs = [np.eye(4, 8, dtype=np.float32)]
    path = str(tmp_path / "a")
    create_index(docs * 3, path, IndexConfig(nbits=2), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        update(docs, path, UpdateConfig(start_from_scratch=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        update_or_create_with_metadata(docs, str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        find_outliers(docs[0], docs[0], 0.5)
    assert update(docs, path, UpdateConfig(start_from_scratch=0), device="cpu") == [3]


def test_device_setup_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    DeviceIndex.load(GOLDEN, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_console_scripts_name_the_port():
    """Each of the JAX package's console scripts has a `-torch` twin whose
    entry point is the port's same `main`; the kernel sources are package
    data."""
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    jax_scripts = {k: v for k, v in scripts.items() if v.startswith("nextplaid_tpu.")}
    assert len(jax_scripts) == 4
    for name, target in jax_scripts.items():
        port = scripts[f"{name}-torch"]
        assert port == target.replace("nextplaid_tpu.", "nextplaid_tpu_torch.", 1)
        module, func = port.split(":")
        assert callable(getattr(importlib.import_module(module), func))
    data = project["tool"]["setuptools"]["package-data"]["nextplaid_tpu_torch"]
    for pattern in data:
        assert glob.glob(os.path.join(PACKAGE, pattern))
