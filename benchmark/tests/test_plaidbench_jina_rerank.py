"""The jina-colbert-v2 rerank cell's pieces on the CPU: the work
arithmetic at the published widths, the global attention bound and its
reader on synthetic records, the model directory the program loads, and a
whole run of `closed_rerank_xlmr` at a tiny size, sound and with its int8
control."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT
from plaidbench import xlmr_corpus, xlmr_work
from plaidbench.harness import Run
from plaidbench.registry import Registry

CELL = "jinacolbert.rerank32.long"
TINY_GAP = 3e-5


def _cell():
    reg = Registry(ROOT)
    w = reg.cell(CELL)
    return reg, dict(reg.config(w["config"])), dict(reg.mix(w["traffic"]))


def _tiny(cfg, mix):
    cfg.update(vocab_size=400, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=96, embedding_dim=16, document_length=256)
    mix.update(documents_per_request=5, pool_requests=3, trace_seconds=0.3,
               doclens=dict(mix["doclens"], median=60, min=24, max=256), check={"requests": 2})
    return cfg, mix


def test_the_configuration_is_published_widths():
    reg, cfg, mix = _cell()
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["intermediate_size"], cfg["vocab_size"]) == (1024, 24, 16, 4096, 250002)
    assert cfg["position_embedding_type"] == "rotary" and cfg["reduced"] == []
    assert mix["driver"] == "closed_rerank_xlmr" and mix["trace_seconds"] == 5
    entry = next(c for c in reg.spec["configs"] if c["name"] == "jina_colbert_v2_long")
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]


def test_request_work_at_the_published_widths():
    """A request of 32 documents of 1,024 tokens and a 32-token query: ~604
    MFLOP of dense work a token, 24 global layers of attention."""
    _, cfg, _ = _cell()
    h, ff = 1024, 4096
    per_token = 24 * (8 * h * h + 4 * h * ff)
    assert per_token == 603_979_776
    tokens = 32 + 32 * 1024
    want = (tokens * (per_token + 2 * h * 128)
            + 4 * h * 24 * (32 ** 2 + 32 * 1024 ** 2) + 2 * 32 * 32 * 1024 * 128)
    assert xlmr_work.request_ops(32, [1024] * 32, cfg) == pytest.approx(want)
    assert xlmr_work.attention_pairs([3, 5], cfg) == 24 * 34


def test_global_attention_bound():
    """Per forward, the operations at the bf16 peak or the launches' bytes
    at the memory's rate, whichever is longer."""
    long = {"encode.live_tokens": 8192.0, "encode.attn_pairs_global": 24 * 8192.0 ** 2,
            "encode.attn_layers_global": 24.0}
    short = {"encode.live_tokens": 32.0, "encode.attn_pairs_global": 24 * 32.0 ** 2,
             "encode.attn_layers_global": 24.0}
    h = 1024
    assert xlmr_work.global_attention_bound_s([long], h) == pytest.approx(4 * h * 24 * 8192 ** 2 / 989e12)
    assert xlmr_work.global_attention_bound_s([short], h) == pytest.approx(24 * 8 * 32 * h / 3.35e12)
    assert xlmr_work.global_attention_bound_s([long, short], h) == pytest.approx(
        4 * h * 24 * 8192 ** 2 / 989e12 + 24 * 8 * 32 * h / 3.35e12)


def _rec(kind, name, value, batch):
    return SimpleNamespace(kind=kind, name=name, value=value, batch=batch)


def test_readers_on_synthetic_records(monkeypatch):
    reg, cfg, _ = _cell()
    recs = []
    for b in (1, 2):
        recs += [_rec("span", "encode.prepare", 4.0, b), _rec("span", "encode.prepare", 2.0, b),
                 _rec("count", "encode.live_tokens", 32.0, b), _rec("count", "encode.token_slots", 32.0, b),
                 _rec("count", "encode.attn_pairs_global", 24 * 32.0 ** 2, b),
                 _rec("count", "encode.attn_pairs_local", 0.0, b),
                 _rec("count", "encode.attn_layers_global", 24.0, b),
                 _rec("device", "encode.forward", 10.0 * b, b)]
    import plaidbench.program_trace as pt

    monkeypatch.setattr(pt, "records", lambda ctx: recs if ctx.get("on_card") else None)
    ctx = {"on_card": True, "config": cfg, "window_s": 2.0, "window_ops": 989e12,
           "trace": {"device_s_by_name": {"varlen_attention_kernel": 1e-3, "other": 5.0},
                     "window_s": 8.0, "busy_s": 6.0}}
    names = [m["name"] for m in reg.per_layer(CELL)]
    assert names == ["device_idle_pct.qps", "encode_forward_span_ms.qps", "encode_prepare_ms.qps",
                     "rerank_step_mfu.qps", "encode_global_attention_roofline.qps"]
    read = {n: reg.reader(n).read(ctx) for n in names}
    assert read["device_idle_pct.qps"] == 25.0
    assert read["encode_forward_span_ms.qps"] == 15.0
    assert read["encode_prepare_ms.qps"] == 6.0
    assert read["rerank_step_mfu.qps"] == pytest.approx(50.0)
    bound = 2 * 24 * 8 * 32 * 1024 / 3.35e12
    assert read["encode_global_attention_roofline.qps"] == pytest.approx(100 * bound / 1e-3)
    assert all(reg.reader(n).read({"on_card": False}) is None for n in names)
    # A program that does not count global launches leaves the roofline unread.
    recs[:] = [r for r in recs if r.name != "encode.attn_layers_global"]
    assert reg.reader("encode_global_attention_roofline.qps").read(ctx) is None


def test_model_dir_holds_the_flash_names(tmp_path):
    """The model directory the cell writes: the flash names under
    `roberta.` and `linear.weight` in one state dict, the markers in the
    tokenizer, and a config the port reads as the rotary family."""
    from safetensors.numpy import load_file

    from nextplaid_tpu_torch.encoder import Colbert
    from nextplaid_tpu_torch.encoder.model import RotaryBertConfig

    _, cfg, mix = _cell()
    cfg, _ = _tiny(cfg, mix)
    path = xlmr_corpus.write_model_dir(cfg, 2**33 + 1, torch.device("cpu"), tmp_path)
    sd = load_file(str(path / "model.safetensors"))
    assert {k: v.shape for k, v in sd.items()} == xlmr_corpus.hf_shapes(cfg)
    norm = sd["roberta.encoder.layers.1.norm2.weight"]
    assert abs(float(norm.mean()) - 1.0) < 0.1 and abs(float(sd["roberta.emb_ln.bias"].mean())) < 0.1
    enc = Colbert(str(path), device="cpu")
    assert isinstance(enc.backbone_config, RotaryBertConfig) and enc._packed
    assert enc._query_prefix_id == 5 and enc._document_prefix_id == 6
    assert json.loads((path / "colbert_config.json").read_text())["attend_to_expansion_tokens"]


@pytest.mark.parametrize("fault", ["sound", "quantized", "cross_document"])
def test_a_tiny_run_on_the_cpu(fault):
    """`closed_rerank_xlmr`'s run at a tiny size: a sound run's embeddings
    lie within bf16 rounding of the reference's; the int8 mode and
    attention across documents lie further (mean cosine gaps ~1e-5, 8.9e-5
    and 4.3e-3 at this seed; TINY_GAP splits the first two about their
    geometric mean)."""
    reg, cfg, mix = _cell()
    cfg, mix = _tiny(cfg, mix)
    drv = reg.driver(mix["driver"])
    control = None if fault == "sound" else {"kind": fault}
    run = Run(CELL, cfg, mix, 2**31 + 17, 0.5, fault == "sound", torch.device("cpu"),
              time.perf_counter(), control)
    with pytest.raises(RuntimeError, match="CUDA"):
        drv.drive(run)
    out = drv.run_rerank(run)
    n = out["numbers"]
    assert n["missing"] == 0 and n["compared"] == min(2, out["attempted"]) * (1 + 5)
    assert out["attempted"] > 0 and set(out["e2e"]) == {"qps", "setup_s"}
    if fault == "sound":
        assert n["emb_cos_gap_mean"] < TINY_GAP and n["emb_cos_gap_max"] < 1e-3 and "ctx" in out
        assert (out["ctx"]["window_ops"] > 0) == (out["e2e"]["qps"] > 0)
    else:
        assert n["emb_cos_gap_mean"] > TINY_GAP


def test_cross_document_control_is_undone():
    """The planted fault hands each packed forward one document of all its
    tokens, and only inside its block."""
    from nextplaid_tpu_torch.encoder.model import ColbertModel

    drv = Registry(ROOT).driver("closed_rerank_xlmr")
    before = ColbertModel.forward_packed
    seen = []
    ColbertModel.forward_packed = lambda self, ids, pos, cu: seen.append(cu.tolist())
    try:
        with drv._planted({"kind": "cross_document"}):
            ColbertModel.forward_packed(None, None, None, torch.tensor([0, 2, 5, 9], dtype=torch.int32))
        ColbertModel.forward_packed(None, None, None, torch.tensor([0, 2, 5, 9], dtype=torch.int32))
    finally:
        ColbertModel.forward_packed = before
    assert seen == [[0, 9], [0, 2, 5, 9]]
