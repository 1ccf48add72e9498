"""jina-colbert-v2's model directory made real for one run, from the seed.

`write_model_dir` writes what `Colbert(model_dir=...)` loads for the rotary
XLM-RoBERTa family: config.json (the keys of MODEL_KEYS), model.safetensors
by the names of Jina's flash XLM-RoBERTa under `roberta.` with the ColBERT
projection `linear.weight` beside them (one state dict, as the checkpoint
keeps it), a WordLevel tokenizer.json and colbert_config.json. The
vocabulary and the rerank requests are `encoder_corpus`'s (`words`,
`requests`), with ids 5 and 6 named by the configuration's query and
document markers.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from plaidbench import corpus, encoder_corpus

MODEL_KEYS = (
    "model_type", "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "max_position_embeddings", "type_vocab_size", "layer_norm_eps",
    "hidden_act", "position_embedding_type", "rotary_emb_base",
)
PREFIX = "roberta."


def hf_shapes(cfg: dict) -> dict:
    """Each weight's shape by the flash implementation's name (under
    `roberta.`), and the projection's."""
    h, ff, n = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(cfg["num_hidden_layers"])
    shapes = {"embeddings.word_embeddings.weight": (int(cfg["vocab_size"]), h),
              "embeddings.token_type_embeddings.weight": (int(cfg["type_vocab_size"]), h),
              "emb_ln.weight": (h,), "emb_ln.bias": (h,)}
    for i in range(n):
        b = f"encoder.layers.{i}."
        for name, (out_f, in_f) in (("mixer.Wqkv", (3 * h, h)), ("mixer.out_proj", (h, h)),
                                    ("mlp.fc1", (ff, h)), ("mlp.fc2", (h, ff))):
            shapes[b + name + ".weight"] = (out_f, in_f)
            shapes[b + name + ".bias"] = (out_f,)
        for norm in ("norm1", "norm2"):
            shapes[b + norm + ".weight"] = (h,)
            shapes[b + norm + ".bias"] = (h,)
    out = {PREFIX + k: v for k, v in shapes.items()}
    out["linear.weight"] = (int(cfg["embedding_dim"]), h)
    return out


def write_model_dir(cfg: dict, seed: int, device: torch.device, root: Path) -> Path:
    """The model directory of `cfg` with random weights from `seed`, drawn
    on `device`, under `root`: linear layers normal with variance 1/fan_in,
    biases 0.1 normal, LayerNorm scales 1 + 0.1 normal, embeddings
    standard normal."""
    from safetensors.torch import save_file
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit
    from tokenizers.processors import TemplateProcessing

    path = Path(root) / "model"
    path.mkdir(parents=True)
    gen = torch.Generator(device=device).manual_seed(corpus.sub_seed(seed, "weights"))
    weights = {}
    for name, shape in hf_shapes(cfg).items():
        w = torch.randn(shape, generator=gen, device=device)
        if len(shape) == 1:  # a bias, or a LayerNorm's scale (".weight") or bias
            w = 0.1 * w + (1.0 if name.endswith(".weight") else 0.0)
        elif "embeddings." not in name:
            w /= float(np.sqrt(shape[1]))
        weights[name] = w.cpu()
    save_file(weights, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({k: cfg[k] for k in MODEL_KEYS}))
    names = encoder_corpus.words(cfg)
    names[encoder_corpus.Q_PREFIX] = cfg["query_prefix"].strip()
    names[encoder_corpus.D_PREFIX] = cfg["document_prefix"].strip()
    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(names)}, unk_token="[UNK]"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.post_processor = TemplateProcessing(
        single="[CLS] $A [SEP]",
        special_tokens=[("[CLS]", encoder_corpus.CLS), ("[SEP]", encoder_corpus.SEP)])
    tok.save(str(path / "tokenizer.json"))
    (path / "colbert_config.json").write_text(json.dumps(dict(
        query_prefix=cfg["query_prefix"], document_prefix=cfg["document_prefix"],
        query_length=int(cfg["query_length"]), document_length=int(cfg["document_length"]),
        embedding_dim=int(cfg["embedding_dim"]), do_query_expansion=bool(cfg["do_query_expansion"]),
        attend_to_expansion_tokens=bool(cfg["attend_to_expansion_tokens"]),
        mask_token_id=encoder_corpus.MASK, pad_token_id=encoder_corpus.PAD,
        skiplist_words=list(cfg["skiplist_words"]), uses_token_type_ids=False,
        do_lower_case=False, model_type="ColBERT")))
    return path
