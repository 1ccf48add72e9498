"""The rerank cell's pieces on the CPU: the encoder work arithmetic, the
requests drawn from the seed, its per-layer readers on synthetic records,
and a whole run of `closed_rerank` at a tiny size, sound and with its planted
faults."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT
from plaidbench import encoder_corpus, encoder_work
from plaidbench.harness import Run
from plaidbench.registry import Registry

CELL = "moderncolbert.rerank32.long"


def _cell():
    reg = Registry(ROOT)
    w = reg.cell(CELL)
    return reg, dict(reg.config(w["config"])), dict(reg.mix(w["traffic"]))


def _tiny(cfg, mix):
    cfg.update(vocab_size=400, hidden_size=64, num_hidden_layers=4, num_attention_heads=2,
               intermediate_size=96, embedding_dim=16, document_length=256,
               max_position_embeddings=256)
    mix.update(documents_per_request=5, pool_requests=3, trace_seconds=0.3,
               doclens=dict(mix["doclens"], median=60, min=24, max=256), check={"requests": 2})
    return cfg, mix


def test_attention_pairs_count_the_band():
    _, cfg, _ = _cell()
    lens = [1, 64, 65, 66, 129, 300]
    g, loc = encoder_work.attention_pairs(lens, cfg)
    band = sum(sum(1 for i in range(n) for j in range(n) if abs(i - j) <= 64) for n in lens)
    assert encoder_work.layer_kinds(cfg) == (8, 14)
    assert g == 8 * sum(n * n for n in lens) and loc == 14 * band


def test_request_work_at_the_published_widths():
    """A request of 32 documents of 1,024 tokens and a 32-token query."""
    _, cfg, _ = _cell()
    ops = encoder_work.request_ops(32, [1024] * 32, cfg)
    h, ff = 768, 1152
    dense = (32 + 32 * 1024) * (22 * (2 * h * 3 * h + 2 * h * h + 4 * h * ff + 2 * ff * h) + 2 * h * 128)
    assert ops == pytest.approx(dense + 4 * h * sum(encoder_work.attention_pairs([32], cfg))
                                + 4 * h * sum(encoder_work.attention_pairs([1024] * 32, cfg))
                                + 2 * 32 * 32 * 1024 * 128)
    fwd = {"encode.live_tokens": 1024.0, "encode.attn_pairs_global": 8 * 1024.0 ** 2,
           "encode.attn_pairs_local": 14 * (1024 * 129 - 64 * 65.0)}
    bound = encoder_work.attention_bound_s([fwd], cfg)
    assert bound == pytest.approx(4 * h * 8 * 1024 ** 2 / 989e12
                                  + max(4 * h * 14 * (1024 * 129 - 64 * 65) / 989e12,
                                        14 * 8 * 1024 * h / 3.35e12))


def test_requests_reproduce_from_the_seed():
    _, cfg, mix = _cell()
    mix = dict(mix, pool_requests=2)
    a, b = (encoder_corpus.requests(cfg, mix, 2**33 + 5) for _ in range(2))
    assert [r.documents for r in a] == [r.documents for r in b]
    for r in a:
        assert len(r.documents) == 32 and len(r.query_row) == 32
        assert all(64 <= len(row) <= 8192 for row in r.doc_rows)
        assert [len(t.split()) + 3 for t in r.documents] == [len(row) for row in r.doc_rows]
    other = encoder_corpus.requests(cfg, mix, 2**33 + 6)
    assert [r.documents for r in other] != [r.documents for r in a]


def _rec(kind, name, value, batch):
    return SimpleNamespace(kind=kind, name=name, value=value, batch=batch)


def test_readers_on_synthetic_records(monkeypatch):
    reg, cfg, _ = _cell()
    recs = []
    for b in (1, 2):
        recs += [_rec("span", "encode.prepare", 4.0, b), _rec("span", "encode.prepare", 2.0, b),
                 _rec("count", "encode.live_tokens", 32.0, b), _rec("count", "encode.token_slots", 32.0, b),
                 _rec("count", "encode.attn_pairs_global", 8 * 32.0 ** 2, b),
                 _rec("count", "encode.attn_pairs_local", 14 * 32.0 ** 2, b),
                 _rec("device", "encode.forward", 10.0 * b, b)]
    import plaidbench.program_trace as pt

    monkeypatch.setattr(pt, "records", lambda ctx: recs if ctx.get("on_card") else None)
    ctx = {"on_card": True, "config": cfg, "window_s": 2.0, "window_ops": 989e12,
           "trace": {"device_s_by_name": {"varlen_attention_kernel": 1e-3, "other": 5.0}}}
    read = {m["name"]: reg.reader(m["name"]).read(ctx) for m in reg.per_layer(CELL)}
    assert read["encode_forward_span_ms.qps"] == 15.0
    assert read["encode_prepare_ms.qps"] == 6.0
    assert read["encode_live_pct.qps"] == 100.0
    assert read["rerank_step_mfu.qps"] == pytest.approx(50.0)
    bound = 2 * encoder_work.attention_bound_s(encoder_work.forwards_of(recs)[:1], cfg)
    assert read["encode_attention_roofline.qps"] == pytest.approx(100 * bound / 1e-3)
    assert all(reg.reader(m["name"]).read({"on_card": False}) is None for m in reg.per_layer(CELL))


@pytest.mark.parametrize("fault", ["sound", "quantized", "all_global"])
def test_a_tiny_run_on_the_cpu(fault):
    """`closed_rerank`'s run at a tiny size: a sound run's embeddings lie within
    bf16 rounding of the reference's; the int8 mode and every layer global
    lie further."""
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
    assert n["missing"] == 0 and n["compared"] == 2 * (1 + 5)
    assert out["attempted"] > 0 and set(out["e2e"]) == {"qps", "setup_s"}
    if fault == "sound":
        assert n["emb_cos_gap_max"] < 1e-3 and "ctx" in out
    else:
        assert n["emb_cos_gap_mean"] > 1e-4
