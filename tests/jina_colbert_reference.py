"""Plain float32 reference of jina-colbert-v2's encoder and of MaxSim
scoring, independent of the program under test.

The architecture is jina-colbert-v2's (https://huggingface.co/jinaai/
jina-colbert-v2, arXiv:2408.16672): Jina's XLM-RoBERTa with rotary
positions (https://huggingface.co/jinaai/xlm-roberta-flash-implementation)
under a ColBERT head. For one document of token ids x_0 .. x_{L-1}:

  h = LayerNorm_emb(E_word[x] + E_type[0])            (no position table)
  layer i (0 .. n-1), every one global, post-LayerNorm (BERT's order):
    q, k, v = h Wqkv^T + bqkv split as [3, heads, head_dim]
    q, k = RoPE(q), RoPE(k) at positions 0 .. L-1, rotate-half over the
           whole head: angle_{p, j} = p * theta^(-2j / head_dim),
           theta = rotary_emb_base
    s = q k^T / sqrt(head_dim) over the whole document
    h = LayerNorm1(h + softmax(s) v Wo^T + bo)
    h = LayerNorm2(h + GELU(h W1^T + b1) W2^T + b2)
  e = h Linear^T (no bias);  e = e / max(||e||, 1e-12)

GELU is the exact (erf) one, HF's "gelu"; every LayerNorm has a scale and
a bias and eps `layer_norm_eps`. MaxSim(query, doc) = sum over query tokens
of the max over document tokens of their dot product.

Assumed, not read from the checkpoint: rotate-half over the whole head
(flash-attn's default, not interleaved), theta from `rotary_emb_base` in
config.json (20,000, jina-embeddings-v3's, in the benchmark's config), and
the weight names of Jina's flash implementation under `roberta.`:
`embeddings.word_embeddings`, `embeddings.token_type_embeddings`,
`emb_ln`, `encoder.layers.{i}.mixer.Wqkv`, `.mixer.out_proj`, `.norm1`,
`.mlp.fc1`, `.mlp.fc2`, `.norm2`; the projection is `linear.weight`.

Everything runs in float32 with TF32 off, one document at a time at its
own length; attention runs a few heads at a time so that the scores of an
8,192-token document fit a card. Weights come from `model.safetensors` or
`pytorch_model.bin`. It imports numpy and torch only (safetensors to read
weights).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

HEAD_BLOCK = 4  # heads whose [L, L] scores are held at once
PREFIX = "roberta."


def _read(path: Path) -> Dict[str, torch.Tensor]:
    if path.with_suffix(".safetensors").exists():
        from safetensors.torch import load_file

        return load_file(str(path.with_suffix(".safetensors")))
    return torch.load(str(path.with_suffix(".bin")), map_location="cpu", weights_only=True)


class JinaColbertReference:
    """The encoder of the module docstring over `weights` (the flash
    implementation's names, `roberta.` stripped) and `config` (config.json's
    keys), the projection `dense` [dim, hidden]."""

    def __init__(self, weights: Dict[str, torch.Tensor], config: dict,
                 dense: torch.Tensor, device="cpu"):
        self.device = torch.device(device)
        self.w = {k: torch.as_tensor(v).to(self.device, torch.float32) for k, v in weights.items()}
        self.dense = torch.as_tensor(dense).to(self.device, torch.float32)
        self.layers = int(config["num_hidden_layers"])
        self.heads = int(config["num_attention_heads"])
        self.hidden = int(config["hidden_size"])
        self.eps = float(config["layer_norm_eps"])
        self.theta = float(config["rotary_emb_base"])

    @classmethod
    def from_dir(cls, model_dir, device="cpu") -> "JinaColbertReference":
        model_dir = Path(model_dir)
        config = json.loads((model_dir / "config.json").read_text())
        weights = _read(model_dir / "model")
        dense = weights.pop("linear.weight")
        weights = {k[len(PREFIX):] if k.startswith(PREFIX) else k: v for k, v in weights.items()}
        return cls(weights, config, dense, device)

    def _norm(self, x, name):
        return F.layer_norm(x, (self.hidden,), self.w[name + ".weight"], self.w[name + ".bias"],
                            self.eps)

    def _linear(self, x, name):
        return x @ self.w[name + ".weight"].T + self.w[name + ".bias"]

    def _rope(self, x):
        d = x.shape[-1]
        inv = 1.0 / (self.theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
        ang = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)[:, None] * inv.float()
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., : d // 2], x[..., d // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, h, i):
        L, hd = h.shape[0], self.hidden // self.heads
        b = f"encoder.layers.{i}.mixer."
        qkv = self._linear(h, b + "Wqkv").reshape(L, 3, self.heads, hd)
        q, k, v = self._rope(qkv[:, 0]), self._rope(qkv[:, 1]), qkv[:, 2]
        out = torch.empty(L, self.heads, hd, device=h.device)
        for h0 in range(0, self.heads, HEAD_BLOCK):
            sl = slice(h0, min(h0 + HEAD_BLOCK, self.heads))
            qh, kh, vh = (t[:, sl].transpose(0, 1) for t in (q, k, v))
            s = qh @ kh.transpose(1, 2) / math.sqrt(hd)
            out[:, sl] = (torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
            del s
        return self._linear(out.reshape(L, self.hidden), b + "out_proj")

    @torch.no_grad()
    def encode(self, ids: Sequence[int]) -> torch.Tensor:
        """One document's [L, dim] float32 unit embeddings."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        emb = (self.w["embeddings.word_embeddings.weight"][x]
               + self.w["embeddings.token_type_embeddings.weight"][0])
        h = self._norm(emb, "emb_ln")
        for i in range(self.layers):
            b = f"encoder.layers.{i}."
            h = self._norm(h + self._attention(h, i), b + "norm1")
            mlp = self._linear(F.gelu(self._linear(h, b + "mlp.fc1")), b + "mlp.fc2")
            h = self._norm(h + mlp, b + "norm2")
        e = h @ self.dense.T
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def maxsim(query: torch.Tensor, doc: torch.Tensor, keep: Optional[torch.Tensor] = None) -> float:
    """MaxSim of [Tq, d] query against [T, d] doc in float32 (the rows of
    doc where `keep`, when given); 0 for a document with no row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    doc = doc if keep is None else doc[keep]
    if doc.shape[0] == 0:
        return 0.0
    return float((query.float() @ doc.float().T).max(dim=1).values.sum())
