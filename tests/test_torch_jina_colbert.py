"""jina-colbert-v2's architecture on the port's packed path: the rotary,
post-LayerNorm BERT family (`encoder.model.BertBackbone` with
`RotaryBertConfig`: Jina's XLM-RoBERTa, every layer global, RoPE at
`rotary_emb_base`, fused biased Q, K, V) in its padded and packed forwards
and through `Colbert(model_dir=...)`'s entry points (`encode_queries`,
`encode_documents`, the server's `/rerank_with_encoding`), against the
plain float32 reference `tests/jina_colbert_reference.py`, on seeded
random weights at a small size: 2 layers, hidden 128, 2 heads of 64, an MLP
of 256, a vocabulary of 512.

Tolerances:
  - float32: |difference| <= F32_ATOL (1e-5) on every token, the encoder's
    float32 bound (tests/test_torch_encoder.py). The port and the reference
    compute the same float32 operations in other orders (fused Q, K, V in
    the compute dtype's matmul, RoPE tables from a host float32 inverse
    frequency, LayerNorm through `F.layer_norm` on both): the largest
    difference at this seed is 1.6e-7. Each planted fault lies outside it:
    post-LN computed as pre-LN, RoPE at theta 10,000 in place of 20,000,
    the token-type embedding left out, and attention across the documents
    of a packed forward (`cu_seqlens` [0, N]). RoPE positions that do not
    restart per document are no fault: attention stays within a document
    and RoPE is relative, so a document's constant shift cancels in
    q . k, and moves a token only through the float32 rounding of larger
    angles (8.6e-7 where the positions run on over this test's 2,058
    tokens, inside the bound).
  - bfloat16 (the cuda case, at 16 heads of 64): least per-token cosine
    >= BF16_MIN_COS against the float32 reference, the encoder's bound
    (tests/test_torch_encoder.py's BF16_GAP_MIN_COS).
The card tests run on an H100 with
`python -m pytest --noconftest -m cuda -rP tests/test_torch_jina_colbert.py`.
"""

from __future__ import annotations

import asyncio
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nextplaid_tpu_torch.encoder import Colbert
from nextplaid_tpu_torch.encoder import model as TM
from nextplaid_tpu_torch.ops import attention as A
from nextplaid_tpu_torch.utils import trace

sys.path.insert(0, str(Path(__file__).resolve().parent))
from jina_colbert_reference import JinaColbertReference  # noqa: E402  (beside this file)

F32_ATOL = 1e-5
BF16_MIN_COS = 0.999
LENS = (1500, 1, 63, 65, 129, 300)
HIDDEN, LAYERS, HEADS, FF, PROJ, VOCAB = 128, 2, 2, 256, 32, 512
SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[QueryMarker]", "[DocumentMarker]",
           ".", ",")
CONFIG = dict(
    model_type="xlm-roberta", vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
    num_attention_heads=HEADS, intermediate_size=FF, max_position_embeddings=8194,
    type_vocab_size=1, layer_norm_eps=1e-5, hidden_act="gelu",
    position_embedding_type="rotary", rotary_emb_base=20_000.0,
)


def flash_weights(hidden=HIDDEN, layers=LAYERS, ff=FF, vocab=VOCAB, proj=PROJ, seed=0):
    """Float32 weights by the flash implementation's names (without
    `roberta.`): LeCun-normal linear layers, biases and norms moved off
    zero and one, embeddings of variance 1/hidden; the projection [proj, hidden]."""
    rng = np.random.default_rng(seed)

    def lin(name, out_f, in_f):
        w[name + ".weight"] = (rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32)
        w[name + ".bias"] = (0.1 * rng.standard_normal(out_f)).astype(np.float32)

    def norm(name):
        w[name + ".weight"] = (1 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
        w[name + ".bias"] = (0.1 * rng.standard_normal(hidden)).astype(np.float32)

    w = {"embeddings.word_embeddings.weight":
         (rng.standard_normal((vocab, hidden)) / np.sqrt(hidden)).astype(np.float32),
         "embeddings.token_type_embeddings.weight":
         (rng.standard_normal((1, hidden)) / np.sqrt(hidden)).astype(np.float32)}
    norm("emb_ln")
    for i in range(layers):
        b = f"encoder.layers.{i}."
        lin(b + "mixer.Wqkv", 3 * hidden, hidden)
        lin(b + "mixer.out_proj", hidden, hidden)
        norm(b + "norm1")
        lin(b + "mlp.fc1", ff, hidden)
        lin(b + "mlp.fc2", hidden, ff)
        norm(b + "norm2")
    dense = (rng.standard_normal((proj, hidden)) / np.sqrt(hidden)).astype(np.float32)
    return w, dense


WEIGHTS, DENSE = flash_weights()


def port_model(dtype, device="cpu", config=CONFIG, weights=WEIGHTS, dense=DENSE):
    cfg = TM.BackboneConfig.from_dict(dict(config, projection_dim=dense.shape[0]))
    sd = TM.params_from_jax({"backbone": TM._map_xlmr_rotary(weights, cfg),
                             "projection": {"kernel": TM._kernel(dense)}})
    model = TM.ColbertModel(cfg, compute_dtype=dtype, device=device)
    model.load_state_dict(sd)
    return model


def packed_inputs(lens=LENS, seed=1, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(0, vocab, n) for n in lens]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32)
    return ids, torch.from_numpy(np.concatenate(ids)), torch.from_numpy(TM.packed_positions(lens)), cu


def reference_rows(ids, config=CONFIG, weights=WEIGHTS, dense=DENSE, device="cpu"):
    ref = JinaColbertReference(weights, config, dense, device)
    return torch.cat([ref.encode(x) for x in ids])


def min_cos(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def padded(ids):
    out = np.zeros((len(ids), max(map(len, ids))), np.int64)
    mask = np.zeros_like(out)
    for i, x in enumerate(ids):
        out[i, : len(x)], mask[i, : len(x)] = x, 1
    return torch.from_numpy(out), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def want():
    return reference_rows(packed_inputs()[0])


def test_config_is_the_rotary_bert_family():
    cfg = TM.BackboneConfig.from_dict(CONFIG)
    assert isinstance(cfg, TM.RotaryBertConfig) and cfg.rotary
    assert cfg.rotary_emb_base == 20_000.0 and cfg.layer_windows() == (None, None)
    model = port_model(torch.float32)
    assert isinstance(model.backbone, TM.BertBackbone)
    assert model.backbone.position_embeddings is None
    names = set(model.state_dict())
    assert "backbone.layer_0.attention.Wqkv.bias" in names
    assert not any(".query." in n or "position_embeddings" in n for n in names)


def test_packed_forward_matches_reference_f32(want):
    _, flat, pos, cu = packed_inputs()
    with torch.inference_mode():
        got = port_model(torch.float32).forward_packed(flat, pos, cu)
    assert got.shape == (sum(LENS), PROJ)
    assert float((got - want).abs().max()) <= F32_ATOL


def test_padded_forward_matches_reference_f32(want):
    ids, *_ = packed_inputs()
    x, mask = padded(ids)
    with torch.inference_mode():
        got = port_model(torch.float32)(x, mask)[mask.bool()]
    assert float((got - want).abs().max()) <= F32_ATOL


def _pre_ln(layer):
    """The layer computed in pre-LayerNorm order."""

    def forward(self, hidden, layout):
        hidden = hidden + self.attention(self.attention_norm(hidden), layout)
        return hidden + self.output(self.act(self.intermediate(self.output_norm(hidden))))

    layer.forward = types.MethodType(forward, layer)


@pytest.mark.parametrize("fault", ["pre_ln", "cross_document", "theta_10000", "no_token_type"])
def test_planted_faults_fail(fault, want):
    """Each departure from the architecture lies outside the float32 bound."""
    _, flat, pos, cu = packed_inputs()
    model = port_model(torch.float32)
    layers = [getattr(model.backbone, f"layer_{i}") for i in range(LAYERS)]
    if fault == "pre_ln":
        for layer in layers:
            _pre_ln(layer)
    elif fault == "cross_document":
        cu = cu[[0, -1]]
    elif fault == "theta_10000":
        for layer in layers:
            layer.attention.theta = 10_000.0
    else:
        with torch.no_grad():
            model.backbone.token_type_embeddings.embedding.zero_()
    with torch.inference_mode():
        got = model.forward_packed(flat, pos, cu)
    assert float((got - want).abs().max()) > F32_ATOL


def test_unrestarted_rope_positions_are_equivalent(want):
    """Positions that run on across a packed forward's documents give each
    document's tokens the same answer within F32_ATOL: attention stays
    within a document and RoPE depends only on relative position."""
    _, flat, _, cu = packed_inputs()
    with torch.inference_mode():
        got = port_model(torch.float32).forward_packed(flat, torch.arange(sum(LENS)), cu)
    assert float((got - want).abs().max()) <= F32_ATOL


def test_bert_absolute_packed_matches_padded():
    """The post-LN layer's layouts with absolute positions (BERT's table at
    each token's position in its document): the packed forward's tokens
    are the padded forward's live rows."""
    cfg = TM.BackboneConfig(model_type="bert", vocab_size=VOCAB, hidden_size=64,
                            num_hidden_layers=2, num_attention_heads=2, intermediate_size=96,
                            max_position_embeddings=512, projection_dim=16)
    model = TM.ColbertModel(cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(TM.init_random_params(cfg, seed=3))
    ids, flat, pos, cu = packed_inputs(lens=(1, 63, 65, 129, 300))
    x, mask = padded(ids)
    with torch.inference_mode():
        got = model.forward_packed(flat, pos, cu)
        want = model(x, mask)[mask.bool()]
    assert float((got - want).abs().max()) <= F32_ATOL


def test_rope_tables_are_cached_bit_for_bit():
    """`_rope_tables` builds theta^(-2i / d) once per (theta, d) and gives
    the values it gave when it built them each call."""
    pos = torch.from_numpy(TM.packed_positions([5, 300, 1500]))
    for d, theta in ((64, 20_000.0), (64, 160_000.0), (32, 10_000.0)):
        inv = torch.from_numpy((1.0 / (theta ** (np.arange(0, d, 2) / d))).astype(np.float32))
        angles = pos.to(torch.float32)[..., None] * inv
        cos, sin = TM._rope_tables(pos, d, theta)
        hits = TM._inv_freq.cache_info().hits
        again = TM._rope_tables(pos, d, theta)
        assert TM._inv_freq.cache_info().hits == hits + 1
        for got in (cos, again[0]):
            assert torch.equal(got, torch.cos(angles))
        for got in (sin, again[1]):
            assert torch.equal(got, torch.sin(angles))


def test_reference_copies_are_identical():
    tests = Path(__file__).resolve().parent
    bench = tests.parent / "benchmark" / "reference" / "jina_colbert.py"
    assert (tests / "jina_colbert_reference.py").read_bytes() == bench.read_bytes()


# ---------------------------------------------------------------------------
# The model directory and the entry points
# ---------------------------------------------------------------------------


def write_model_dir(path: Path, document_length: int) -> Path:
    """A model directory as jina-colbert-v2's checkpoint lays it out, as far
    as `Colbert(model_dir=...)` reads it: config.json, model.safetensors with
    the flash names under `roberta.` and the projection `linear.weight`, a
    WordLevel tokenizer.json with the query and document markers, and
    colbert_config.json."""
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit
    from tokenizers.processors import TemplateProcessing

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(CONFIG))
    save_file({**{"roberta." + k: v for k, v in WEIGHTS.items()}, "linear.weight": DENSE},
              str(path / "model.safetensors"))
    vocab = {w: i for i, w in enumerate(SPECIAL + tuple(f"w{i}" for i in range(VOCAB - len(SPECIAL))))}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])])
    tok.save(str(path / "tokenizer.json"))
    (path / "colbert_config.json").write_text(json.dumps(dict(
        query_prefix="[QueryMarker]", document_prefix="[DocumentMarker]", query_length=32,
        document_length=document_length, embedding_dim=PROJ, mask_token_id=vocab["[MASK]"],
        pad_token_id=vocab["[PAD]"], skiplist_words=[".", ","], uses_token_type_ids=False,
        attend_to_expansion_tokens=True, do_lower_case=False)))
    return path


def texts_and_rows(word_counts, seed=2):
    """Texts of "w<i>" words with a "." every 7th word, and the rows the
    encoder must form from them ([CLS], [DocumentMarker], the words, [SEP])."""
    rng = np.random.default_rng(seed)
    texts, rows = [], []
    for n in word_counts:
        words = [f"w{i}" for i in rng.integers(0, VOCAB - len(SPECIAL), n)]
        words = [w if j % 7 != 6 else "." for j, w in enumerate(words)]
        texts.append(" ".join(words))
        rows.append([2, 6] + [7 if w == "." else len(SPECIAL) + int(w[1:]) for w in words] + [3])
    return texts, rows


def query_row(words):
    ids = [2, 5] + [len(SPECIAL) + int(w[1:]) for w in words.split()] + [3]
    return ids + [4] * (32 - len(ids))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_model_dir(tmp_path_factory.mktemp("jina") / "model", document_length=310)


def test_loader_reads_the_flash_names(model_dir):
    """`load_params` maps `roberta.`'s flash names and the top-level
    `linear.weight` onto the rotary backbone, value for value."""
    cfg = TM.BackboneConfig.from_model_dir(model_dir)
    cfg.projection_dim = PROJ
    got = TM.load_params(model_dir, cfg)
    want = port_model(torch.float32).state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_loader_refuses_absolute_roberta(model_dir):
    """A RoBERTa config with absolute positions (counted from past the
    padding id, which BERT's table does not do) is refused, not loaded."""
    from nextplaid_tpu_torch.utils.errors import EncodingError

    cfg = TM.BackboneConfig.from_dict(dict(CONFIG, position_embedding_type="absolute"))
    assert not cfg.rotary
    with pytest.raises(EncodingError, match="absolute positions"):
        TM.load_params(model_dir, cfg)


def test_colbert_model_dir_entry_points(model_dir):
    """`Colbert(model_dir=...)` loads the family and runs it packed; in
    float32, its documents (skiplist dropped) and [MASK]-expanded queries
    are the reference's within F32_ATOL, and each packed forward counts
    its pairs from its layers: all global."""
    enc = Colbert(str(model_dir), batch_size=2, device="cpu")
    assert enc._packed and isinstance(enc.model.backbone, TM.BertBackbone)
    served = enc.model
    enc.model = port_model(torch.float32)
    texts, rows = texts_and_rows([297, 1, 60, 62, 126, 40, 200])
    with trace.recording(), trace.batch_scope() as batch:
        got = enc.encode_documents(texts)
    recs = [r for r in trace.records() if r.batch == batch]
    counts = [r for r in recs if r.kind == "count"]
    live = [r.value for r in counts if r.name == "encode.live_tokens"]
    sorted_lens = sorted(len(r) for r in rows)
    assert live == [sum(sorted_lens[:-1]), sorted_lens[-1]]  # budget 2 x 310
    assert [r.value for r in counts if r.name == "encode.attn_pairs_global"] == [
        LAYERS * sum(n * n for n in sorted_lens[:-1]), LAYERS * sorted_lens[-1] ** 2]
    assert [r.value for r in counts if r.name == "encode.attn_pairs_local"] == [0, 0]
    assert [r.value for r in counts if r.name == "encode.attn_layers_global"] == [LAYERS] * 2
    assert any(r.kind == "span" and r.name == "encode.prepare" for r in recs)
    ref = JinaColbertReference.from_dir(model_dir)
    for text_rows, emb in zip(rows, got):
        keep = np.asarray(text_rows) != 7
        want = ref.encode(text_rows)[torch.from_numpy(keep)]
        assert emb.shape == (int(keep.sum()), PROJ)
        assert float(np.abs(emb - want.numpy()).max()) <= F32_ATOL
    queries = enc.encode_queries(["w1 w2 w3", "w4 . w5"])
    want = ref.encode(query_row("w1 w2 w3"))
    assert queries[0].shape == queries[1].shape == (32, PROJ)
    assert float(np.abs(queries[0] - want.numpy()).max()) <= F32_ATOL
    enc.model = served  # the checkpoint as loaded: bf16 compute
    bf16 = enc.encode_queries(["w1 w2 w3"])[0]
    assert min_cos(torch.from_numpy(bf16), want) >= BF16_MIN_COS


def test_rerank_with_encoding(model_dir, tmp_path):
    """The server's `/rerank_with_encoding` over the family: the reference's
    MaxSim of its own embeddings, best first."""
    from aiohttp.test_utils import TestClient, TestServer

    from nextplaid_tpu_torch.api.server import build_app
    from jina_colbert_reference import maxsim

    enc = Colbert(str(model_dir), batch_size=2, device="cpu")
    enc.model = port_model(torch.float32)
    texts, rows = texts_and_rows([30, 5, 120, 64], seed=5)
    query = "w11 w12 w13 w14"

    async def post():
        app = build_app(str(tmp_path / "indices"), encoder=enc, device="cpu")
        async with TestClient(TestServer(app)) as client:
            r = await client.post("/rerank_with_encoding", json={"query": query, "documents": texts})
            return r.status, await r.json()

    status, body = asyncio.run(post())
    assert status == 200, body
    ref = JinaColbertReference.from_dir(model_dir)
    q = ref.encode(query_row(query))
    want = [maxsim(q, ref.encode(r), torch.tensor(r) != 7) for r in rows]
    results = body["results"]
    assert [r["index"] for r in results] == sorted(range(len(rows)), key=lambda i: -want[i])
    for r in results:
        assert abs(r["score"] - want[r["index"]]) <= 32 * F32_ATOL


def test_trace_counters():
    """`encode.attn_pairs_global` = layers x sum L^2, local 0, and
    `encode.attn_layers_global` = layers, from the layers' own kinds."""
    enc = Colbert.__new__(Colbert)
    enc.backbone_config = TM.BackboneConfig.from_dict(dict(CONFIG, num_hidden_layers=24))
    lens = np.asarray([1, 5, 64, 8192], np.int64)
    with trace.recording(), trace.batch_scope() as batch:
        enc._count_packed(lens, batch)
    got = {r.name: r.value for r in trace.records() if r.batch == batch}
    assert got == {"encode.live_tokens": 8262, "encode.token_slots": 8262,
                   "encode.attn_pairs_global": 24 * int((lens * lens).sum()),
                   "encode.attn_pairs_local": 0, "encode.attn_layers_global": 24}


@pytest.mark.parametrize("layers,every,window", [(22, 3, 128), (4, 3, 8), (5, 2, 16)])
def test_modernbert_counters_unchanged(layers, every, window):
    """ModernBERT's counters keep the values they had when they were
    computed from `global_attn_every_n_layers` and `local_attention`, and
    `encode.attn_layers_global` is its number of global layers."""
    enc = Colbert.__new__(Colbert)
    enc.backbone_config = TM.BackboneConfig(
        model_type="modernbert", num_hidden_layers=layers, global_attn_every_n_layers=every,
        local_attention=window)
    lens = np.asarray([1, 5, 6, 9, 20, 300], np.int64)
    with trace.recording(), trace.batch_scope() as batch:
        enc._count_packed(lens, batch)
    got = {r.name: r.value for r in trace.records() if r.batch == batch}
    n_global = len(range(0, layers, every))
    w = window // 2
    band = np.where(lens <= w + 1, lens * lens, lens * (2 * w + 1) - w * (w + 1))
    assert got == {"encode.live_tokens": 341, "encode.token_slots": 341,
                   "encode.attn_pairs_global": n_global * int((lens * lens).sum()),
                   "encode.attn_pairs_local": (layers - n_global) * int(band.sum()),
                   "encode.attn_layers_global": n_global}
    windows = TM.BackboneConfig(model_type="modernbert", num_hidden_layers=layers,
                                global_attn_every_n_layers=every, local_attention=window)
    model = TM.ColbertModel(windows, torch.float32, device="meta")
    assert [getattr(model.backbone, f"layer_{i}").attn.half_window
            for i in range(layers)] == list(windows.layer_windows())


@pytest.mark.parametrize("fault", [None, "cross_document", "launches_uncounted"])
def test_chip_smoke_jina_check_catches_what_it_holds(fault, monkeypatch, tmp_path):
    """chip_smoke.py's `jina_check` at this file's widths on the CPU, a
    counting plain version standing in for the kernel: it passes the
    served path, counts one launch a layer of each packed forward, and
    refuses attention across documents and launches left uncounted."""
    import chip_smoke

    plain = A.varlen_attention_reference

    def kernel(q, k, v, cu_seqlens, half_window, scale, rope=None, tiles=None):
        if fault != "launches_uncounted":
            kernel.launches += 1
        if fault == "cross_document":
            cu_seqlens = cu_seqlens[[0, -1]]
        return plain(q, k, v, cu_seqlens, half_window, scale, rope)

    kernel.launches = 0
    monkeypatch.setattr(A, "varlen_attention", kernel)
    monkeypatch.setattr(TM, "varlen_attention", kernel)
    monkeypatch.setattr(chip_smoke, "attention_lengths", lambda: np.asarray([5, 63, 65, 129, 700]))
    check = lambda: chip_smoke.jina_check("cpu", CONFIG, PROJ, str(tmp_path))  # noqa: E731
    if fault is not None:
        with pytest.raises(AssertionError):
            check()
        return
    out = check()
    assert out["jina_forwards"] == 1 and out["jina_forward_launches"] == LAYERS
    assert out["jina_launches"] == 2 * LAYERS  # and the warm-up's forward
    assert out["jina_encoder_least_cos"] >= chip_smoke.ENC_MIN_COS_BF16


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernel has no CPU mode")
    return torch.device("cuda")


WIDE = dict(CONFIG, hidden_size=1024, num_attention_heads=16, intermediate_size=4096)
WIDE_LENS = (64, 300, 1024, 2900, 8192)


@pytest.mark.cuda
def test_card_packed_forward_at_16_heads(cuda):
    """The card's packed forward at the published widths of a layer (16
    heads of 64, hidden 1,024, MLP 4,096; two layers), bf16, one attention
    launch a layer, against the float32 reference on the card."""
    weights, dense = flash_weights(hidden=1024, ff=4096, proj=128, seed=4)
    ids, flat, pos, cu = packed_inputs(lens=WIDE_LENS, seed=6)
    model = port_model(torch.bfloat16, cuda, WIDE, weights, dense)
    with torch.inference_mode():
        before = A.varlen_attention.launches
        got = model.forward_packed(flat.to(cuda), pos.to(cuda), cu.to(cuda))
        torch.cuda.synchronize()
    assert A.varlen_attention.launches - before == LAYERS
    want = reference_rows(ids, WIDE, weights, dense, cuda)
    cos = min_cos(got, want)
    print(f"{sum(WIDE_LENS)} tokens, 16 x 64 heads, bf16: least cosine {cos:.6f}")
    assert cos >= BF16_MIN_COS
