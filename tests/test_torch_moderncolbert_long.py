"""GTE-ModernColBERT-v1's architecture on packed documents: the port's
packed ModernBERT forward (`ColbertModel.forward_packed`, which reaches
`ops.attention.varlen_attention`'s plain version on the CPU and its kernel
on the card) and `Colbert(model_dir=...)` against the plain float32
reference `tests/moderncolbert_reference.py`, on seeded random weights at
a small size: 4 layers (0 and 3 global, 1 and 2 local over the published
128-token window), hidden 128, 2 heads of 64, documents of 1, 63, 65, 129
and 300 tokens in one packed forward.

Tolerances:
  - float32: |difference| <= F32_ATOL on every token. The port and the
    reference compute the same float32 operations in other orders; the
    largest difference at this seed is 3.4e-7. RoPE is relative, so RoPE
    positions that do not restart per document change the scores only
    through float32 rounding of larger angles: 1.5e-6 here, which this
    bound (their geometric mean) still sees. Attention without the window
    moves tokens by 0.18.
  - bfloat16: least per-token cosine >= BF16_MIN_COS against float32, the
    encoder's bound (tests/test_torch_encoder.py's BF16_GAP_MIN_COS).
The card tests run on an H100 with
`python -m pytest --noconftest -m cuda -rP tests/test_torch_moderncolbert_long.py`.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nextplaid_tpu_torch.encoder import Colbert
from nextplaid_tpu_torch.encoder import model as TM
from nextplaid_tpu_torch.ops import attention as A
from nextplaid_tpu_torch.utils import trace

sys.path.insert(0, str(Path(__file__).resolve().parent))
from moderncolbert_reference import ModernColbertReference  # noqa: E402  (beside this file)

F32_ATOL = 7e-7
BF16_MIN_COS = 0.999
LENS = (1, 63, 65, 129, 300)
HIDDEN, LAYERS, HEADS, FF, PROJ = 128, 4, 2, 192, 32
SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]", ".", ",")
VOCAB = 400
CONFIG = dict(
    model_type="modernbert", vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
    num_attention_heads=HEADS, intermediate_size=FF, max_position_embeddings=512,
    local_attention=128, global_attn_every_n_layers=3, global_rope_theta=160_000.0,
    local_rope_theta=10_000.0, norm_eps=1e-5, norm_bias=False, hidden_act="gelu",
)


def hf_weights(seed=0):
    """HF-named float32 weights: LeCun-normal linear layers, embeddings of
    variance 1/hidden, norms' scales moved off one; the projection [PROJ, HIDDEN]."""
    rng = np.random.default_rng(seed)

    def lin(out_f, in_f):
        return (rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32)

    def norm():
        return (1 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)

    w = {"embeddings.tok_embeddings.weight":
         (rng.standard_normal((VOCAB, HIDDEN)) / np.sqrt(HIDDEN)).astype(np.float32),
         "embeddings.norm.weight": norm()}
    for i in range(LAYERS):
        b = f"layers.{i}."
        if i:
            w[b + "attn_norm.weight"] = norm()
        w[b + "attn.Wqkv.weight"] = lin(3 * HIDDEN, HIDDEN)
        w[b + "attn.Wo.weight"] = lin(HIDDEN, HIDDEN)
        w[b + "mlp_norm.weight"] = norm()
        w[b + "mlp.Wi.weight"] = lin(2 * FF, HIDDEN)
        w[b + "mlp.Wo.weight"] = lin(HIDDEN, FF)
    w["final_norm.weight"] = norm()
    return w, lin(PROJ, HIDDEN)


WEIGHTS, DENSE = hf_weights()


def port_model(dtype, device="cpu"):
    cfg = TM.BackboneConfig.from_dict(dict(CONFIG, projection_dim=PROJ))
    sd = TM.params_from_jax({"backbone": TM._map_modernbert(WEIGHTS, cfg),
                             "projection": {"kernel": TM._kernel(DENSE)}})
    model = TM.ColbertModel(cfg, compute_dtype=dtype, device=device)
    model.load_state_dict(sd)
    return model


def packed_inputs(lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(0, VOCAB, n) for n in lens]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32)
    return ids, torch.from_numpy(np.concatenate(ids)), torch.from_numpy(TM.packed_positions(lens)), cu


def reference_rows(ids):
    ref = ModernColbertReference(WEIGHTS, CONFIG, DENSE)
    return torch.cat([ref.encode(x) for x in ids])


def min_cos(a, b):
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def test_packed_forward_matches_reference_f32():
    ids, flat, pos, cu = packed_inputs()
    with torch.inference_mode():
        got = port_model(torch.float32).forward_packed(flat, pos, cu)
    want = reference_rows(ids)
    assert got.shape == (sum(LENS), PROJ)
    assert float((got - want).abs().max()) <= F32_ATOL


def test_packed_forward_bf16_cosine():
    ids, flat, pos, cu = packed_inputs()
    with torch.inference_mode():
        got = port_model(torch.bfloat16).forward_packed(flat, pos, cu)
    assert min_cos(got, reference_rows(ids)) >= BF16_MIN_COS


@pytest.mark.parametrize("fault", ["window_removed", "rope_unrestarted"])
def test_planted_faults_fail(fault):
    """Both faults the cell's `correct` is meant to see break the float32
    bound: every local layer attending to the whole document, and RoPE
    positions counted over the whole packed forward."""
    ids, flat, pos, cu = packed_inputs()
    model = port_model(torch.float32)
    if fault == "window_removed":
        for i in range(LAYERS):
            getattr(model.backbone, f"layer_{i}").attn.half_window = None
    else:
        pos = torch.arange(sum(LENS))
    with torch.inference_mode():
        got = model.forward_packed(flat, pos, cu)
    assert float((got - reference_rows(ids)).abs().max()) > F32_ATOL


def test_packed_and_padded_forwards_agree():
    """The packed forward's tokens are the padded (JAX chain) forward's
    live rows."""
    ids, flat, pos, cu = packed_inputs()
    padded = np.zeros((len(LENS), max(LENS)), np.int64)
    mask = np.zeros_like(padded)
    for i, x in enumerate(ids):
        padded[i, : len(x)], mask[i, : len(x)] = x, 1
    model = port_model(torch.float32)
    with torch.inference_mode():
        got = model.forward_packed(flat, pos, cu)
        want = model(torch.from_numpy(padded), torch.from_numpy(mask))[torch.from_numpy(mask).bool()]
    assert float((got - want).abs().max()) <= F32_ATOL


def test_reference_copies_are_identical():
    tests = Path(__file__).resolve().parent
    bench = tests.parent / "benchmark" / "reference" / "moderncolbert.py"
    assert (tests / "moderncolbert_reference.py").read_bytes() == bench.read_bytes()


def test_plain_attention_is_the_band_within_each_document():
    """The plain version against one dense masked softmax over the whole
    packed batch: same document and, on local layers, inside the band."""
    rng = np.random.default_rng(3)
    n, h, d = sum(LENS), 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((n, h, d)).astype(np.float32)) for _ in range(3))
    cu = torch.tensor(np.concatenate([[0], np.cumsum(LENS)]), dtype=torch.int32)
    doc = torch.repeat_interleave(torch.arange(len(LENS)), torch.tensor(LENS))
    pos = torch.from_numpy(TM.packed_positions(LENS))
    for hw in (None, 64, 0):
        allow = doc[:, None] == doc[None, :]
        if hw is not None:
            allow &= (pos[:, None] - pos[None, :]).abs() <= hw
        s = torch.einsum("ihd,jhd->hij", q, k) * 0.25
        want = torch.einsum("hij,jhd->ihd", torch.softmax(s.masked_fill(~allow, -torch.inf), -1), v)
        got = A.varlen_attention(q, k, v, cu, hw, 0.25)
        assert float((got - want).abs().max()) <= 1e-5


def write_model_dir(path: Path, document_length: int) -> Path:
    """A model directory as `Colbert(model_dir=...)` loads it: config.json,
    model.safetensors and 1_Dense/ by HF names, a WordLevel tokenizer.json
    and colbert_config.json."""
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit
    from tokenizers.processors import TemplateProcessing

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(CONFIG))
    save_file(WEIGHTS, str(path / "model.safetensors"))
    (path / "1_Dense").mkdir(exist_ok=True)
    save_file({"linear.weight": DENSE}, str(path / "1_Dense" / "model.safetensors"))
    vocab = {w: i for i, w in enumerate(SPECIAL + tuple(f"w{i}" for i in range(VOCAB - len(SPECIAL))))}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])])
    tok.save(str(path / "tokenizer.json"))
    (path / "colbert_config.json").write_text(json.dumps(dict(
        query_prefix="[Q] ", document_prefix="[D] ", query_length=32,
        document_length=document_length, embedding_dim=PROJ, mask_token_id=vocab["[MASK]"],
        pad_token_id=vocab["[PAD]"], skiplist_words=[".", ","], uses_token_type_ids=False,
        do_lower_case=False)))
    return path


def texts_and_rows(word_counts, seed=2):
    """Texts of "w<i>" words with a "." every 7th word, and the rows the
    encoder must form from them ([CLS], [D], the words, [SEP])."""
    rng = np.random.default_rng(seed)
    texts, rows = [], []
    for n in word_counts:
        words = [f"w{i}" for i in rng.integers(0, VOCAB - len(SPECIAL), n)]
        words = [w if j % 7 != 6 else "." for j, w in enumerate(words)]
        texts.append(" ".join(words))
        rows.append([2, 6] + [7 if w == "." else len(SPECIAL) + int(w[1:]) for w in words] + [3])
    return texts, rows


def test_colbert_model_dir_packs_forwards_by_tokens(tmp_path):
    """`Colbert(model_dir=...)` in float32: output order, shapes and
    skiplist filtering as the padded path gives them, the values the
    reference's, and forwards of consecutive length-sorted documents of at
    most batch_size x document_length live tokens."""
    path = write_model_dir(tmp_path / "model", document_length=310)
    enc = Colbert(str(path), batch_size=2, device="cpu")
    enc.model = port_model(torch.float32)
    texts, rows = texts_and_rows([297, 1, 60, 62, 126, 40, 200])
    with trace.recording(), trace.batch_scope() as batch:
        got = enc.encode_documents(texts)
    recs = [r for r in trace.records() if r.batch == batch]
    live = [r.value for r in recs if r.name == "encode.live_tokens"]
    sorted_lens = [len(rows[i]) for i in sorted(range(len(texts)), key=lambda i: len(texts[i]))]
    assert sorted_lens == [4, 43, 63, 65, 129, 203, 300]
    assert live == [4 + 43 + 63 + 65 + 129 + 203, 300]  # budget 2 x 310
    assert {r.name for r in recs} >= {"encode.prepare", "encode.token_slots",
                                      "encode.attn_pairs_global", "encode.attn_pairs_local"}
    ref = ModernColbertReference.from_dir(path)
    for text_rows, emb in zip(rows, got):
        keep = np.asarray(text_rows) != 7
        want = ref.encode(text_rows)[torch.from_numpy(keep)]
        assert emb.shape == (int(keep.sum()), PROJ)
        assert float(np.abs(emb - want.numpy()).max()) <= F32_ATOL
    queries = enc.encode_queries(["w1 w2 w3", "w4 . w5"])
    ids = [2, 5, len(SPECIAL) + 1, len(SPECIAL) + 2, len(SPECIAL) + 3, 3]
    want = ref.encode(ids + [4] * (32 - len(ids)))
    assert queries[0].shape == (32, PROJ) and queries[1].shape == (32, PROJ)
    assert float(np.abs(queries[0] - want.numpy()).max()) <= F32_ATOL


def test_attention_pair_counters():
    """`encode.attn_pairs_*` count query-key pairs per head over a
    forward's layers: L^2 on each global layer, the band on each local."""
    enc = Colbert.__new__(Colbert)
    enc.backbone_config = TM.BackboneConfig.from_dict(dict(CONFIG, local_attention=8))  # w = 4
    lens = np.asarray([1, 5, 6, 20], np.int64)
    with trace.recording(), trace.batch_scope() as batch:
        enc._count_packed(lens, batch)
    got = {r.name: r.value for r in trace.records() if r.batch == batch}
    band = sum(sum(1 for i in range(n) for j in range(n) if abs(i - j) <= 4) for n in lens)
    assert got["encode.attn_pairs_global"] == 2 * int((lens * lens).sum())
    assert got["encode.attn_pairs_local"] == 2 * band
    assert got["encode.live_tokens"] == got["encode.token_slots"] == 32


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernel has no CPU mode")
    return torch.device("cuda")


def cell_lengths(n=32, seed=7):
    """The rerank cell's document lengths: log-normal, median 1,024, sigma
    1.0, clipped to 64-8,192."""
    rng = np.random.default_rng(seed)
    return np.clip(np.round(1024 * np.exp(rng.standard_normal(n))), 64, 8192).astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("half_window", [None, 64])
def test_kernel_matches_plain_at_the_cells_shapes(cuda, half_window, rope):
    """One launch over a rerank request's 32 documents and an 8,192-token
    one, 12 heads of 64, bf16, with and without the rotary tables."""
    lens = np.sort(np.append(cell_lengths(), 8192))
    n = int(lens.sum())
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=cuda)
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(n, 12, 64, generator=gen).to(cuda, torch.bfloat16) for _ in range(3))
    tables = None
    if rope:
        pos = torch.from_numpy(TM.packed_positions(lens)).to(cuda)
        tables = TM._rope_tables(pos, 64, 10_000.0 if half_window else 160_000.0)
    before = A.varlen_attention.launches
    got = A.varlen_attention(q, k, v, cu, half_window, 0.125, rope=tables)
    torch.cuda.synchronize()
    assert A.varlen_attention.launches == before + 1
    want = A.varlen_attention_reference(q, k, v, cu, half_window, 0.125, rope=tables)
    cos = min_cos(got.float().reshape(-1, 64), want.float().reshape(-1, 64))
    print(f"{n} tokens, half_window {half_window}, rope {rope}: least cosine {cos:.6f}")
    assert cos >= BF16_MIN_COS


@pytest.mark.cuda
def test_card_forward_matches_the_cpu_chain(cuda):
    """The card's packed forward (the kernel, one launch a layer) against
    the CPU's padded float32 forward, the JAX chain, on the live tokens at
    the bf16 bound."""
    ids, flat, pos, cu = packed_inputs()
    padded = np.zeros((len(LENS), max(LENS)), np.int64)
    mask = np.zeros_like(padded)
    for i, x in enumerate(ids):
        padded[i, : len(x)], mask[i, : len(x)] = x, 1
    with torch.inference_mode():
        want = port_model(torch.float32)(torch.from_numpy(padded), torch.from_numpy(mask))
        before = A.varlen_attention.launches
        got = port_model(torch.bfloat16, cuda).forward_packed(
            flat.to(cuda), pos.to(cuda), cu.to(cuda)).cpu()
    assert A.varlen_attention.launches - before == LAYERS
    assert min_cos(got, want[torch.from_numpy(mask).bool()]) >= BF16_MIN_COS


@pytest.mark.parametrize("fault", [None, "band ignored", "rope ignored"])
def test_chip_smoke_attention_check_catches_what_it_holds(fault, monkeypatch):
    """chip_smoke.py's `attention_check` at small lengths, the plain
    version standing in for the kernel: it passes the kernel's own answer,
    its planted faults (a skipped key tile, a narrower band) read below its
    bound, and it refuses a kernel that ignores the band or the rotary
    tables."""
    import chip_smoke

    plain = A.varlen_attention_reference

    def kernel(q, k, v, cu_seqlens, half_window, scale, rope=None, tiles=None):
        A.varlen_attention.launches += 1
        if fault == "band ignored":
            half_window = None
        return plain(q, k, v, cu_seqlens, half_window, scale,
                     None if fault == "rope ignored" else rope)

    monkeypatch.setattr(A, "varlen_attention", kernel)
    kernel.launches = 0
    monkeypatch.setattr(chip_smoke, "attention_lengths", lambda: np.asarray([1, 63, 65, 129, 700]))
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    if fault is not None:
        with pytest.raises(AssertionError):
            chip_smoke.attention_check("cpu")
        return
    out = chip_smoke.attention_check("cpu")
    assert out["least_cos"] >= 1 - 1e-9 and out["local_least_cos"] >= 1 - 1e-9
    assert out["jina_least_cos"] >= 1 - 1e-9
    assert out["max_abs_err"] == 0.0 and out["jina_max_abs_err"] == 0.0
    assert out["fault_skipped_tile_cos"] < chip_smoke.ENC_MIN_COS_BF16
    assert out["fault_narrow_band_cos"] < chip_smoke.ENC_MIN_COS_BF16
    assert out["fault_jina_skipped_tile_cos"] < chip_smoke.ENC_MIN_COS_BF16
    # A check, a fault and a timed launch a layer kind (time_ms runs its function once here):
    # ModernBERT's global and local layers, jina-colbert-v2's global one.
    assert out["check_launches"] == 9 and out["tokens"] == 958 and out["documents"] == 5
    assert out["bound_ms"] >= out["local_bound_ms"] > 0 and out["local_bound_by"] == "bytes"
    assert out["jina_bound_ms"] == pytest.approx(out["bound_ms"] * 16 / 12)


def test_rerank_scores_batch_equals_one_document_at_a_time():
    """`ops.maxsim.rerank_scores`, the rerank handlers' scoring: one batch
    over documents of unequal lengths gives each document's own MaxSim; a
    document with no token scores 0; widths that differ are refused."""
    from nextplaid_tpu_torch.ops.maxsim import maxsim_score, rerank_scores

    rng = np.random.default_rng(4)
    query = rng.standard_normal((32, 16)).astype(np.float32)
    docs = [rng.standard_normal((n, 16)).astype(np.float32) for n in (1, 7, 300, 64, 2)]
    got = rerank_scores(query, docs + [np.zeros((0, 16), np.float32)], "cpu")
    want = [float(maxsim_score(torch.from_numpy(query), torch.from_numpy(d))) for d in docs]
    np.testing.assert_allclose(got[:-1], want, rtol=1e-6)
    assert got[-1] == 0.0 and got.dtype == np.float32
    assert rerank_scores(query, [], "cpu").shape == (0,)
    with pytest.raises(ValueError):
        rerank_scores(query, [np.zeros((3, 8), np.float32)], "cpu")
