"""Plain float32 reference of a ModernBERT ColBERT encoder and of MaxSim
scoring, independent of the program under test.

The architecture is GTE-ModernColBERT-v1's (https://huggingface.co/lightonai/
GTE-ModernColBERT-v1): the ModernBERT backbone (arXiv:2412.13663; HF
transformers' modeling_modernbert.py) under PyLate's ColBERT head. For one
document of token ids x_0 .. x_{L-1}:

  h = LayerNorm(E[x])                                 (no biases anywhere)
  layer i (0 .. n-1), global when i % global_attn_every_n_layers == 0:
    a = h if i == 0 else LayerNorm(h)
    q, k, v = a Wqkv^T split as [3, heads, head_dim]
    q, k = RoPE(q), RoPE(k) at positions 0 .. L-1, rotate-half, with
           theta = global_rope_theta or local_rope_theta
    s_ij = q_i . k_j / sqrt(head_dim), over j = 0 .. L-1 (global) or
           |i - j| <= local_attention // 2 (local, an explicit mask)
    h = h + softmax(s) v Wo^T
    g, u = LayerNorm(h) Wi^T split in halves;  h = h + (GELU(g) * u) Wo^T
  h = LayerNorm(h);  e = h Dense^T;  e = e / max(||e||, 1e-12)

GELU is the exact (erf) one, HF's "gelu". MaxSim(query, doc) = sum over
query tokens of the max over document tokens of their dot product.

Everything runs in float32 with TF32 off, one document at a time at its
own length; attention runs a few heads at a time so that the scores of an
8,192-token document fit a card. Weights are read by HF's names
(`embeddings.tok_embeddings.weight`, `layers.{i}.attn.Wqkv.weight`, ...)
from `model.safetensors` or `pytorch_model.bin`, the projection from
`1_Dense/`. It imports numpy and torch only (safetensors to read weights).
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


def _read(path: Path) -> Dict[str, torch.Tensor]:
    if path.with_suffix(".safetensors").exists():
        from safetensors.torch import load_file

        return load_file(str(path.with_suffix(".safetensors")))
    return torch.load(str(path.with_suffix(".bin")), map_location="cpu", weights_only=True)


class ModernColbertReference:
    """The encoder of the module docstring over `weights` (HF names) and
    `config` (HF config.json's keys), the projection `dense` [dim, hidden]."""

    def __init__(self, weights: Dict[str, torch.Tensor], config: dict,
                 dense: torch.Tensor, device="cpu"):
        self.device = torch.device(device)
        self.w = {k: torch.as_tensor(v).to(self.device, torch.float32) for k, v in weights.items()}
        self.dense = torch.as_tensor(dense).to(self.device, torch.float32)
        self.layers = int(config["num_hidden_layers"])
        self.heads = int(config["num_attention_heads"])
        self.hidden = int(config["hidden_size"])
        self.every = int(config.get("global_attn_every_n_layers", 3))
        self.half_window = int(config.get("local_attention", 128)) // 2
        self.eps = float(config.get("norm_eps", 1e-5))
        self.theta_global = float(config.get("global_rope_theta", 160_000.0))
        self.theta_local = float(config.get("local_rope_theta", 10_000.0))

    @classmethod
    def from_dir(cls, model_dir, device="cpu") -> "ModernColbertReference":
        model_dir = Path(model_dir)
        config = json.loads((model_dir / "config.json").read_text())
        weights = _read(model_dir / "model")
        weights = {k[len("model."):] if k.startswith("model.") else k: v for k, v in weights.items()}
        dense = _read(model_dir / "1_Dense" / "model")["linear.weight"]
        return cls(weights, config, dense, device)

    def _norm(self, x, name):
        return F.layer_norm(x, (self.hidden,), self.w[name], None, self.eps)

    def _rope(self, x, theta):
        d = x.shape[-1]
        inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
        ang = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)[:, None] * inv.float()
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., : d // 2], x[..., d // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, a, i):
        L, hd = a.shape[0], self.hidden // self.heads
        qkv = (a @ self.w[f"layers.{i}.attn.Wqkv.weight"].T).reshape(L, 3, self.heads, hd)
        glob = i % self.every == 0
        theta = self.theta_global if glob else self.theta_local
        q, k, v = self._rope(qkv[:, 0], theta), self._rope(qkv[:, 1], theta), qkv[:, 2]
        allow = None
        if not glob:
            idx = torch.arange(L, device=a.device)
            allow = (idx[:, None] - idx[None, :]).abs() <= self.half_window
        out = torch.empty(L, self.heads, hd, device=a.device)
        for h0 in range(0, self.heads, HEAD_BLOCK):
            sl = slice(h0, min(h0 + HEAD_BLOCK, self.heads))
            qh, kh, vh = (t[:, sl].transpose(0, 1) for t in (q, k, v))
            s = qh @ kh.transpose(1, 2) / math.sqrt(hd)
            if allow is not None:
                s = s.masked_fill(~allow, float("-inf"))
            out[:, sl] = (torch.softmax(s, dim=-1) @ vh).transpose(0, 1)
            del s
        return out.reshape(L, self.hidden) @ self.w[f"layers.{i}.attn.Wo.weight"].T

    @torch.no_grad()
    def encode(self, ids: Sequence[int]) -> torch.Tensor:
        """One document's [L, dim] float32 unit embeddings."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        x = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        h = self._norm(self.w["embeddings.tok_embeddings.weight"][x], "embeddings.norm.weight")
        for i in range(self.layers):
            a = h if i == 0 else self._norm(h, f"layers.{i}.attn_norm.weight")
            h = h + self._attention(a, i)
            g, u = (self._norm(h, f"layers.{i}.mlp_norm.weight")
                    @ self.w[f"layers.{i}.mlp.Wi.weight"].T).chunk(2, dim=-1)
            h = h + (F.gelu(g) * u) @ self.w[f"layers.{i}.mlp.Wo.weight"].T
        e = self._norm(h, "final_norm.weight") @ self.dense.T
        return e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def maxsim(query: torch.Tensor, doc: torch.Tensor, keep: Optional[torch.Tensor] = None) -> float:
    """MaxSim of [Tq, d] query against [T, d] doc in float32 (the rows of
    doc where `keep`, when given); 0 for a document with no row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    doc = doc if keep is None else doc[keep]
    if doc.shape[0] == 0:
        return 0.0
    return float((query.float() @ doc.float().T).max(dim=1).values.sum())
