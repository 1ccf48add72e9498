"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points do not fall back to the CPU when no device is named."""

import ast
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
FORBIDDEN = ("jax", "nextplaid_tpu")


def _sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


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
        "nextplaid_tpu_torch.index.embeddings\n"
        "bad = [m for m in sys.modules if m in ('jax', 'nextplaid_tpu') or "
        "m.startswith(('jax.', 'nextplaid_tpu.'))]\n"
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
