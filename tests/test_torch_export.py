"""`nextplaid_tpu_torch.scripts_export` against `nextplaid_tpu.scripts_export`
on the fixture checkpoint of scripts/fetch_eval_assets.py (a real-format HF
BERT ColBERT checkpoint with random weights): with and without `--quantize`,
the two exports write byte-equal directories (`onnx_config.json`, the
copied weights and tokenizer, `1_Dense/`, and `model.int8.safetensors`)."""

import filecmp
import os
import sys

import pytest

import nextplaid_tpu.encoder.colbert as jax_colbert
from nextplaid_tpu import scripts_export as jax_export
from nextplaid_tpu_torch import scripts_export as port_export

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    import fetch_eval_assets

    path = tmp_path_factory.mktemp("ckpt") / "mini-colbert"
    fetch_eval_assets.write_fixture_checkpoint(path)
    return path


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "quantize"])
def test_export_equals_jax(checkpoint, tmp_path, monkeypatch, capsys, quantize):
    # The JAX package's colbert.py uses `os` without importing it.
    monkeypatch.setattr(jax_colbert, "os", os, raising=False)
    flags = ["--dim", "32", "--query-length", "24"] + (["--quantize"] if quantize else [])
    for main, name, extra in ((jax_export.main, "jax", []),
                              (port_export.main, "port", ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["export", str(checkpoint), str(tmp_path / name),
                                          *flags, *extra])
        main()
    out = capsys.readouterr().out
    assert out.count("encoded shape=(6, 32)") == 2
    if quantize:
        assert out.count("int8 quantized: min per-token cosine") == 2
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    assert ("model.int8.safetensors" in files) == quantize
    assert "onnx_config.json" in files and os.path.join("1_Dense", "model.safetensors") in files
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", files,
                                           shallow=False)
    assert mismatch == [] and errors == []


def test_export_loads_into_the_port(checkpoint, tmp_path, monkeypatch):
    """The exported directory loads with the port's Colbert, and its int8
    artifact holds the weights `quantize_dense_params` derives at load."""
    import numpy as np
    from safetensors.numpy import load_file

    from nextplaid_tpu_torch.encoder import Colbert

    monkeypatch.setattr(sys, "argv", ["export", str(checkpoint), str(tmp_path / "out"),
                                      "--dim", "32", "--quantize", "--device", "cpu"])
    port_export.main()
    enc = Colbert(str(tmp_path / "out"), quantized=True, device="cpu")
    pinned = load_file(str(tmp_path / "out" / "model.int8.safetensors"))
    state = enc.model.state_dict()
    for name, value in pinned.items():
        if name.endswith(("kernel_q", "kernel_scale")):
            np.testing.assert_array_equal(state[name[len("params."):]].cpu().numpy(), value)
    assert enc.encode_queries(["w001 w002"])[0].shape == (enc.config.query_length, 32)
