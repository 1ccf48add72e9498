"""The port's ColBERT encoder against `nextplaid_tpu.encoder` on the CPU.

Each case runs the same seeded numpy inputs, with the same weights (a Flax
tree carried across by `params_from_jax`), through the JAX function and the
port's. Tolerances:
  - float32 compute: |difference| <= 1e-5 on every row, padded rows too
    (both packages compute the same float32 ops in other orders);
  - bfloat16 compute: least per-token cosine >= 0.999 between the packages
    (bf16 products rounded in other orders; XLA may keep float32 between
    bf16 elementwise ops), and >= BF16_GAP_MIN_COS against float32 (the
    bound chip_smoke.py holds the card's bf16 forward to);
  - quantized (int8 weights and activations): least per-token cosine >=
    0.999 between the packages (a row's activation scale can round a value
    to the other int8 step), in float32 and in bfloat16 compute; the
    bfloat16 + int8 chain also >= QUANT_GAP_MIN_COS against the float32
    full-precision forward (tests/test_encoder.py's quantized bound, which
    chip_smoke.py holds the card's quantized forward to).
Tokenization is compared exactly on the hand vocabulary of
tests/test_encoder_vocab.py.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.encoder.colbert as jax_colbert
from nextplaid_tpu.encoder import model as JM
from nextplaid_tpu_torch.encoder import Colbert, ColbertConfig, hub
from nextplaid_tpu_torch.encoder import model as TM
from nextplaid_tpu_torch.utils.errors import EncodingError
from tests.test_encoder import make_tokenizer
from tests.test_encoder_vocab import VOCAB

F32_ATOL = 1e-5
BF16_MIN_COS = 0.999
INT8_MIN_COS = 0.999
BF16_GAP_MIN_COS = 0.999
QUANT_GAP_MIN_COS = 0.99

WIDTHS = {
    "bert": dict(model_type="bert", vocab_size=101, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=96, max_position_embeddings=64,
                 projection_dim=24),
    # Four layers, global every third (layers 0 and 3) and a window of 8 over
    # 40 tokens: both layer kinds and the window bite.
    "modernbert": dict(model_type="modernbert", vocab_size=101, hidden_size=64,
                       num_hidden_layers=4, num_attention_heads=4, intermediate_size=96,
                       max_position_embeddings=64, projection_dim=24, local_attention=8,
                       global_attn_every_n_layers=3),
}


@pytest.fixture(autouse=True)
def jax_colbert_os(monkeypatch):
    """The JAX package's colbert.py uses `os` without importing it."""
    monkeypatch.setattr(jax_colbert, "os", os, raising=False)


def _params(family, seed=0):
    """A JAX param tree (numpy leaves) with norms and biases moved off their
    initial ones and zeros, so every parameter matters."""
    tree = JM.init_random_params(JM.BackboneConfig(**WIDTHS[family]), seed=seed)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        if x.ndim == 1 else np.asarray(x),
        tree,
    )


def _batch(vocab, b=3, length=40, seed=7):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    mask[1, 17:] = 0
    mask[2, 9:] = 0
    return ids, mask


def _forward(family, params, ids, mask, jdtype, tdtype, quantized=False):
    cfg = WIDTHS[family]
    tt = np.zeros_like(ids) if family == "bert" else None
    jp = JM.quantize_dense_params(params) if quantized else params
    want = np.asarray(JM.ColbertModel(JM.BackboneConfig(**cfg), compute_dtype=jdtype,
                                      quantized=quantized).apply(jp, ids, mask, tt))
    sd = TM.params_from_jax(params)
    model = TM.ColbertModel(TM.BackboneConfig(**cfg), compute_dtype=tdtype, quantized=quantized,
                            device="cpu")
    model.load_state_dict(TM.quantize_dense_params(sd) if quantized else sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    None if tt is None else torch.from_numpy(tt)).numpy()
    return got, want


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min())


@pytest.mark.parametrize("family", ["bert", "modernbert"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "int8-bf16"])
def test_colbert_model_matches_jax(family, mode):
    params = _params(family)
    ids, mask = _batch(WIDTHS[family]["vocab_size"])
    if mode == "f32":
        got, want = _forward(family, params, ids, mask, jnp.float32, torch.float32)
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    elif mode == "bf16":
        got, want = _forward(family, params, ids, mask, jnp.bfloat16, torch.bfloat16)
        assert _min_cos(got, want) >= BF16_MIN_COS
        f32, _ = _forward(family, params, ids, mask, jnp.float32, torch.float32)
        assert _min_cos(got, f32) >= BF16_GAP_MIN_COS
    elif mode == "int8":
        got, want = _forward(family, params, ids, mask, jnp.float32, torch.float32, True)
        assert _min_cos(got, want) >= INT8_MIN_COS
    else:
        got, want = _forward(family, params, ids, mask, jnp.bfloat16, torch.bfloat16, True)
        assert _min_cos(got, want) >= INT8_MIN_COS
        f32, _ = _forward(family, params, ids, mask, jnp.float32, torch.float32)
        assert _min_cos(got, f32) >= QUANT_GAP_MIN_COS
    assert got.shape == (3, 40, 24)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-4)


def test_window_and_layer_kinds_matter():
    """The ModernBERT case has teeth: without the window (a local window
    wider than the batch) the port's outputs move far past the tolerance."""
    params = _params("modernbert")
    ids, mask = _batch(101)
    got, _ = _forward("modernbert", params, ids, mask, jnp.float32, torch.float32)
    wide = TM.ColbertModel(TM.BackboneConfig(**dict(WIDTHS["modernbert"], local_attention=128)),
                           compute_dtype=torch.float32, device="cpu")
    wide.load_state_dict(TM.params_from_jax(params))
    with torch.inference_mode():
        other = wide(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert np.abs(other - got).max() > 1e-2


def test_quantize_and_random_params():
    params = _params("bert")
    sd = TM.params_from_jax(params)
    q, jq = TM.quantize_dense_params(sd), TM.params_from_jax(JM.quantize_dense_params(params))
    assert q.keys() == jq.keys()
    for name in q:
        assert q[name].dtype == jq[name].dtype, name
        assert torch.equal(q[name], jq[name]), name
    assert "projection.kernel" in q and "projection.kernel_q" not in q
    cfg = TM.BackboneConfig(**WIDTHS["modernbert"])
    a, b = TM.init_random_params(cfg, seed=3), TM.init_random_params(cfg, seed=3)
    assert a.keys() == TM.params_from_jax(_params("modernbert")).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    kernel = a["backbone.layer_1.Wi.kernel"]
    assert abs(float(kernel.std()) * np.sqrt(kernel.shape[0]) - 1.0) < 0.05
    assert float(kernel.abs().max()) <= 2.0 / 0.87962566 / np.sqrt(kernel.shape[0]) + 1e-6


def _hf_checkpoint(family, tmp_path):
    """A `transformers` checkpoint written by save_pretrained, with a
    `1_Dense/` projection (as tests/test_encoder.py:194 writes one)."""
    transformers = pytest.importorskip("transformers")
    from safetensors.numpy import save_file

    torch.manual_seed(0)
    if family == "bert":
        cfg = transformers.BertConfig(vocab_size=101, hidden_size=64, num_hidden_layers=2,
                                      num_attention_heads=4, intermediate_size=96,
                                      max_position_embeddings=64)
        model = transformers.BertModel(cfg, add_pooling_layer=False)
    else:
        cfg = transformers.ModernBertConfig(
            vocab_size=101, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=64, local_attention=8,
            global_attn_every_n_layers=3, pad_token_id=0, bos_token_id=1, eos_token_id=2,
            cls_token_id=1, sep_token_id=2)
        model = transformers.ModernBertModel(cfg)
    path = tmp_path / family
    model.save_pretrained(str(path), safe_serialization=True)
    (path / "1_Dense").mkdir()
    head = np.random.default_rng(1).standard_normal((24, 64)).astype(np.float32)
    save_file({"linear.weight": head}, str(path / "1_Dense" / "model.safetensors"))
    return path


@pytest.mark.parametrize("family", ["bert", "modernbert"])
def test_hf_checkpoint_loads_into_both(family, tmp_path):
    path = _hf_checkpoint(family, tmp_path)
    jcfg, tcfg = JM.BackboneConfig.from_model_dir(path), TM.BackboneConfig.from_model_dir(path)
    jcfg.projection_dim = tcfg.projection_dim = 24
    assert dataclasses_equal(jcfg, tcfg)
    sd = TM.load_params(path, tcfg)
    jp = JM.load_params(path, jcfg)
    carried = TM.params_from_jax(jp)
    assert sd.keys() == carried.keys()
    assert all(torch.equal(sd[k], carried[k]) for k in sd)
    ids, mask = _batch(101)
    want = np.asarray(JM.ColbertModel(jcfg, compute_dtype=jnp.float32).apply(jp, ids, mask))
    model = TM.ColbertModel(tcfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# Colbert: tokenization, batching, encode entry points
# ---------------------------------------------------------------------------


def _wordpiece():
    from tokenizers import Tokenizer
    from tokenizers.models import WordPiece
    from tokenizers.normalizers import BertNormalizer
    from tokenizers.pre_tokenizers import BertPreTokenizer
    from tokenizers.processors import TemplateProcessing

    vocab = {w: i for i, w in enumerate(VOCAB)}
    tok = Tokenizer(WordPiece(vocab, unk_token="[UNK]"))
    tok.normalizer = BertNormalizer(lowercase=True)
    tok.pre_tokenizer = BertPreTokenizer()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    return tok


def _pair(tok, vocab_size, f32=False, **overrides):
    """The JAX and the port's Colbert on the same weights and config; with
    `f32`, both forwards in float32."""
    cfg = dict(WIDTHS["bert"], vocab_size=vocab_size, projection_dim=16)
    base = dict(query_prefix="[Q]", document_prefix="[D]", query_length=16,
                document_length=24, embedding_dim=16, skiplist_words=[",", ".", "!"])
    base.update(overrides)
    params = JM.init_random_params(JM.BackboneConfig(**cfg), seed=0)
    jenc = jax_colbert.Colbert(config=jax_colbert.ColbertConfig(**base),
                               backbone_config=JM.BackboneConfig(**cfg), tokenizer=tok,
                               params=params, batch_size=4)
    tenc = Colbert(config=ColbertConfig(**base), backbone_config=TM.BackboneConfig(**cfg),
                   tokenizer=tok, params=TM.params_from_jax(params), batch_size=4,
                   device="cpu")
    if f32:
        jenc.model = JM.ColbertModel(jenc.backbone_config, compute_dtype=jnp.float32)
        tenc.model = TM.ColbertModel(tenc.backbone_config, compute_dtype=torch.float32,
                                     device="cpu")
        tenc.model.load_state_dict(TM.params_from_jax(params))
    return jenc, tenc


TEXTS = [
    "Quickly indexing",
    "the quick search engine the fast index the quick engine",
    "search, engine!",
    "zzzunknownzzz",
    "   ",
    "QUANTUM search the FAST engine",
]


@pytest.mark.parametrize("is_query", [False, True])
@pytest.mark.parametrize("expansion", [True, False])
def test_prepare_ids_equal(is_query, expansion):
    overrides = dict(query_length=8, document_length=10, mask_token_id=4, pad_token_id=0,
                     do_lower_case=True, do_query_expansion=expansion)
    jenc, tenc = _pair(_wordpiece(), len(VOCAB), **overrides)
    assert tenc.skiplist_ids == jenc.skiplist_ids == frozenset({14, 15, 16})
    assert (tenc._query_prefix_id, tenc._document_prefix_id) == (5, 6)
    got, want = tenc._prepare(TEXTS, is_query), jenc._prepare(TEXTS, is_query)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got[2:] == want[2:]


DOCS = ["quick fox", "the quick brown fox jumps", "lazy dog over the fox .",
        "a b c , d e", "the quick brown fox jumps over the lazy dog " * 3, "dog"]
QUERIES = ["quick fox", "lazy dog over the fox", "a"]


def test_encode_entry_points_match_jax_f32():
    tok, vocab = make_tokenizer()
    jenc, tenc = _pair(tok, len(vocab), f32=True, mask_token_id=vocab["[MASK]"],
                       pad_token_id=vocab["[PAD]"])
    cases = [
        (tenc.encode_queries(QUERIES), jenc.encode_queries(QUERIES)),
        (tenc.encode_documents(DOCS), jenc.encode_documents(DOCS)),
        (tenc.encode_documents(DOCS, filter_skiplist=False),
         jenc.encode_documents(DOCS, filter_skiplist=False)),
        (tenc.encode_documents(DOCS, pool_factor=2), jenc.encode_documents(DOCS, pool_factor=2)),
        ([e for c in tenc.encode_documents_stream(iter(DOCS), batch_size=2) for e in c],
         [e for c in jenc.encode_documents_stream(iter(DOCS), batch_size=2) for e in c]),
    ]
    for got, want in cases:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, np.asarray(w), atol=F32_ATOL, rtol=0)
    jenc.config.do_query_expansion = tenc.config.do_query_expansion = False
    for g, w in zip(tenc.encode_queries(QUERIES), jenc.encode_queries(QUERIES)):
        np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_encode_matches_jax_bf16(quantized):
    tok, vocab = make_tokenizer()
    cfg = dict(WIDTHS["bert"], vocab_size=len(vocab), projection_dim=16)
    ccfg = dict(query_prefix="[Q]", document_prefix="[D]", query_length=16,
                document_length=24, embedding_dim=16, mask_token_id=vocab["[MASK]"],
                pad_token_id=vocab["[PAD]"])
    params = JM.init_random_params(JM.BackboneConfig(**cfg), seed=1)
    jenc = jax_colbert.Colbert(config=jax_colbert.ColbertConfig(**ccfg),
                               backbone_config=JM.BackboneConfig(**cfg), tokenizer=tok,
                               params=params, batch_size=4, quantized=quantized)
    tenc = Colbert(config=ColbertConfig(**ccfg), backbone_config=TM.BackboneConfig(**cfg),
                   tokenizer=tok, params=TM.params_from_jax(params), batch_size=4,
                   quantized=quantized, device="cpu")
    bound = INT8_MIN_COS if quantized else BF16_MIN_COS
    for got, want in ((tenc.encode_documents(DOCS), jenc.encode_documents(DOCS)),
                      (tenc.encode_queries(QUERIES), jenc.encode_queries(QUERIES))):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _min_cos(g, w) >= bound


def test_colbert_from_model_dir(tmp_path):
    """A model directory (weights, 1_Dense/, tokenizer.json,
    onnx_config.json) loads into both packages' Colbert alike."""
    path = _hf_checkpoint("bert", tmp_path)
    tok = _wordpiece()
    tok.save(str(path / "tokenizer.json"))
    jax_colbert.ColbertConfig(query_prefix="[Q]", document_prefix="[D]", query_length=8,
                              document_length=10, embedding_dim=24, mask_token_id=4,
                              do_lower_case=True).save(path / "onnx_config.json")
    jenc = jax_colbert.Colbert(str(path))
    tenc = Colbert(str(path), device="cpu")
    assert tenc.config == ColbertConfig(**jenc.config.to_dict())
    for g, w in zip(tenc.encode_documents(TEXTS), jenc.encode_documents(TEXTS)):
        assert g.shape == w.shape and _min_cos(g, w) >= BF16_MIN_COS


def test_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok, vocab = make_tokenizer()
    cfg = TM.BackboneConfig(**dict(WIDTHS["bert"], vocab_size=len(vocab), projection_dim=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Colbert(config=ColbertConfig(embedding_dim=16), backbone_config=cfg, tokenizer=tok)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.ColbertModel(cfg)


def test_hub_local_dir_and_offline_id(tmp_path, monkeypatch):
    local = tmp_path / "model"
    local.mkdir()
    assert hub.resolve_model_dir(local) == local
    assert hub.resolve_model_dir(str(local)) == local

    calls = []

    def offline(repo, allow_patterns=None, local_files_only=False):
        calls.append(local_files_only)
        raise OSError("offline")  # neither cached nor reachable

    fake = types.ModuleType("huggingface_hub")
    fake.snapshot_download = offline
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)
    with pytest.raises(EncodingError, match="org/unknown"):
        hub.resolve_model_dir("org/unknown")
    assert calls == [True, False]  # the cache first
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(EncodingError, match="huggingface_hub is unavailable"):
        hub.resolve_model_dir("org/unknown")
