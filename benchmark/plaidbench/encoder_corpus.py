"""A ColBERT encoder configuration made real for one run, and its rerank
requests, from the seed.

`write_model_dir` writes the model directory `Colbert(model_dir=...)`
loads: config.json (HF ModernBERT's keys), model.safetensors by HF's names,
1_Dense/model.safetensors (PyLate's projection), a WordLevel
tokenizer.json and colbert_config.json. `requests` draws the traffic mix's
pool of rerank requests: one query and `documents_per_request` documents
each, as texts and as the token rows the encoder must form from them
([CLS], the prefix, the words, [SEP]; queries expanded with [MASK] to
query_length), which the reference encodes on its own.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

from plaidbench import corpus

SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[Q]", "[D]", ".", ",")
PAD, UNK, CLS, SEP, MASK, Q_PREFIX, D_PREFIX, PERIOD, COMMA = range(len(SPECIAL))
PERIOD_EVERY, COMMA_EVERY = 20, 13
MODEL_KEYS = (
    "model_type", "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "max_position_embeddings", "local_attention",
    "global_attn_every_n_layers", "global_rope_theta", "local_rope_theta", "norm_eps",
    "norm_bias", "attention_bias", "mlp_bias", "hidden_act",
)


def hf_shapes(cfg: dict) -> dict:
    """Each HF-named weight's shape."""
    h, ff, n = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(cfg["num_hidden_layers"])
    shapes = {"embeddings.tok_embeddings.weight": (int(cfg["vocab_size"]), h),
              "embeddings.norm.weight": (h,), "final_norm.weight": (h,)}
    for i in range(n):
        b = f"layers.{i}."
        if i:
            shapes[b + "attn_norm.weight"] = (h,)
        shapes.update({b + "attn.Wqkv.weight": (3 * h, h), b + "attn.Wo.weight": (h, h),
                       b + "mlp_norm.weight": (h,), b + "mlp.Wi.weight": (2 * ff, h),
                       b + "mlp.Wo.weight": (h, ff)})
    return shapes


def write_model_dir(cfg: dict, seed: int, device: torch.device, root: Path) -> Path:
    """The model directory of `cfg` with random weights from `seed`, drawn
    on `device`, under `root`."""
    from safetensors.torch import save_file
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit
    from tokenizers.processors import TemplateProcessing

    path = Path(root) / "model"
    (path / "1_Dense").mkdir(parents=True)
    gen = torch.Generator(device=device).manual_seed(corpus.sub_seed(seed, "weights"))
    weights = {}
    for name, shape in hf_shapes(cfg).items():
        if len(shape) == 1:
            w = 1.0 + 0.1 * torch.randn(shape, generator=gen, device=device)
        elif name.startswith("embeddings."):
            w = torch.randn(shape, generator=gen, device=device)
        else:
            w = torch.randn(shape, generator=gen, device=device) / float(np.sqrt(shape[1]))
        weights[name] = w.cpu()
    h, dim = int(cfg["hidden_size"]), int(cfg["embedding_dim"])
    dense = torch.randn((dim, h), generator=gen, device=device) / float(np.sqrt(h))
    save_file(weights, str(path / "model.safetensors"))
    save_file({"linear.weight": dense.cpu()}, str(path / "1_Dense" / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({k: cfg[k] for k in MODEL_KEYS}))
    vocab = {w: i for i, w in enumerate(words(cfg))}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", CLS), ("[SEP]", SEP)])
    tok.save(str(path / "tokenizer.json"))
    (path / "colbert_config.json").write_text(json.dumps(dict(
        query_prefix=cfg["query_prefix"], document_prefix=cfg["document_prefix"],
        query_length=int(cfg["query_length"]), document_length=int(cfg["document_length"]),
        embedding_dim=dim, do_query_expansion=bool(cfg["do_query_expansion"]),
        mask_token_id=MASK, pad_token_id=PAD, skiplist_words=list(cfg["skiplist_words"]),
        uses_token_type_ids=False, do_lower_case=False, model_type="ColBERT")))
    return path


def words(cfg: dict) -> List[str]:
    """The vocabulary in id order: the special tokens, then w0, w1, ..."""
    return list(SPECIAL) + [f"w{i}" for i in range(int(cfg["vocab_size"]) - len(SPECIAL))]


@dataclass
class Request:
    query: str
    documents: List[str]
    query_row: List[int]  # the expanded query's token ids
    doc_rows: List[List[int]]  # each document's token ids, skiplist included


def doclens(mix: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """`n` document lengths in tokens ([CLS], prefix and [SEP] included)."""
    spec = mix["doclens"]
    if spec["kind"] != "lognormal_clipped":
        raise ValueError(f"unknown doclens kind {spec['kind']!r}")
    draw = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.round(draw), spec["min"], spec["max"]).astype(np.int64)


def _text(ids: np.ndarray, vocab: np.ndarray) -> tuple:
    """Words of `ids` (word numbers) with the skiplist marks put in; the
    text and its token ids."""
    tokens = ids + len(SPECIAL)
    pos = np.arange(len(ids))
    tokens = np.where(pos % PERIOD_EVERY == PERIOD_EVERY - 1, PERIOD,
                      np.where(pos % COMMA_EVERY == COMMA_EVERY - 1, COMMA, tokens))
    return " ".join(vocab[tokens].tolist()), tokens.tolist()


def requests(cfg: dict, mix: dict, seed: int) -> List[Request]:
    """The pool of `pool_requests` requests drawn from `seed`: each query
    of `query_words` words taken from one of its documents."""
    rng = np.random.default_rng(corpus.sub_seed(seed, "rerank-requests"))
    vocab = np.asarray(words(cfg))
    n_words = int(cfg["vocab_size"]) - len(SPECIAL)
    ql, qw = int(cfg["query_length"]), int(mix["query_words"])
    out = []
    for _ in range(int(mix["pool_requests"])):
        lens = doclens(mix, int(mix["documents_per_request"]), rng)
        texts, rows = [], []
        for n in lens:
            text, toks = _text(rng.integers(0, n_words, int(n) - 3), vocab)
            texts.append(text)
            rows.append([CLS, D_PREFIX, *toks, SEP])
        src = rows[int(rng.integers(0, len(rows)))][2:-1]
        start = int(rng.integers(0, max(1, len(src) - qw)))
        q_toks = src[start : start + qw]
        query = " ".join(vocab[q_toks].tolist())
        q_row = [CLS, Q_PREFIX, *q_toks, SEP]
        q_row += [MASK] * (ql - len(q_row))
        out.append(Request(query, texts, q_row, rows))
    return out
