"""ColBERT encoder as `torch.nn`: transformer backbone + projection + L2 norm.

PyTorch counterpart of `nextplaid_tpu.encoder.model` (next-plaid-onnx's
exported graph: backbone -> Dense(dim, no bias) -> normalize). Two backbone
families:
  - BERT (post-LayerNorm, biased dense layers, every layer global), with
    learned absolute positions: answerai-colbert-small, colbert-v2 style
    checkpoints; or with rotary positions on every layer and a fused Q, K,
    V (`position_embedding_type: "rotary"`): Jina's XLM-RoBERTa,
    jina-colbert-v2;
  - ModernBERT (pre-LayerNorm, RoPE, GeGLU, alternating local/global
    attention): GTE-ModernColBERT-v1.

The JAX package computes all of it in plain XLA, so here it is plain PyTorch
ops: `torch.matmul` for the dense layers and attention, `torch._int_mm` for
the int8 products of the quantized mode; but for attention on the card in a
packed forward, which is one kernel a layer (`ops.attention.varlen_attention`).
Every layer takes one of two layouts of its tokens:
  - padded [B, L] (`forward`; `_Padded`): the JAX chain below, dense
    [B, H, L, L] scores with a mask bias, on any device; what the parity
    tests against the JAX package hold;
  - packed [N] live tokens with the documents' bounds (`forward_packed`;
    `_Packed`), as HF ModernBERT's unpadded path: positions restart at 0
    in each document, attention never crosses one, a window is a band, and
    nothing of [L, L] is built. The encoder runs the rotary families
    packed everywhere; BERT with absolute positions runs padded.
The dtype chain is the JAX package's, step by step:
  - a backbone dense layer casts its input and weights to the compute dtype
    and returns that dtype (`nn.Dense(dtype=...)`); weights are held in the
    compute dtype, which rounds them as that cast does;
  - embeddings and LayerNorms run and return float32, so residual sums are
    float32 + compute dtype;
  - attention scores are the compute-dtype product divided by sqrt(head
    dim) in float32 (the JAX package divides by a numpy float64, which
    promotes), the -1e9 mask bias and the softmax are float32, and the
    probabilities times the values are a float32 product (the kernel's
    departure: it rounds the probabilities to the compute dtype first);
  - the projection runs in float32, then L2 normalize with a 1e-12 clamp.

Parameter names are the JAX package's Flax tree flattened with dots
(`backbone.layer_0.attention.query.kernel`), kernels laid out [in, out], so
`params_from_jax` carries a Flax tree across unchanged and `load_params`
maps HF checkpoints by the same names. The rotary BERT family, which the
JAX package does not have, names its fused projection
`backbone.layer_0.attention.Wqkv.kernel`. Weights are a plain `state_dict`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nextplaid_tpu_torch.ops.attention import rotate_half, tile_table, varlen_attention
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device
from nextplaid_tpu_torch.utils.errors import EncodingError


@dataclass
class BackboneConfig:
    """Union of the fields we need from HF `config.json` for both families."""

    model_type: str = "bert"  # "bert" | "xlm-roberta" | "modernbert"
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"
    # ModernBERT specifics
    norm_eps: float = 1e-5
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160_000.0
    local_rope_theta: float = 10_000.0
    # ColBERT head
    projection_dim: int = 128

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BackboneConfig":
        """The config of `d`'s family: `RotaryBertConfig` where
        `position_embedding_type` is "rotary", else this class."""
        if d.get("position_embedding_type") == "rotary":
            cls = RotaryBertConfig
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_model_dir(cls, model_dir) -> "BackboneConfig":
        p = Path(model_dir) / "config.json"
        if not p.exists():
            raise EncodingError(f"config.json not found in {model_dir}")
        with open(p) as f:
            return cls.from_dict(json.load(f))

    @property
    def rotary(self) -> bool:
        """Rotary positions: ModernBERT's, and `RotaryBertConfig`'s."""
        return self.model_type == "modernbert"

    def layer_windows(self) -> tuple:
        """Each layer's attention window as the largest |i - j| it lets a
        query reach, None on a global layer: ModernBERT's every
        `global_attn_every_n_layers`-th layer from 0 is global, the rest
        `local_attention` wide; every BERT-family layer is global."""
        n = self.num_hidden_layers
        if self.model_type != "modernbert":
            return (None,) * n
        return tuple(None if i % self.global_attn_every_n_layers == 0
                     else self.local_attention // 2 for i in range(n))


@dataclass
class RotaryBertConfig(BackboneConfig):
    """The BERT family with rotary positions on every layer and no position
    table: Jina's XLM-RoBERTa (jina-colbert-v2), whose config.json says
    `position_embedding_type: "rotary"` and gives `rotary_emb_base`. A
    class of its own, so that the BERT and ModernBERT configs keep the JAX
    package's fields."""

    position_embedding_type: str = "rotary"
    rotary_emb_base: float = 10_000.0

    @property
    def rotary(self) -> bool:
        return True


def _act(name: str):
    """HF's activation names: "gelu" is the exact erf GELU (HF's ACT2FN),
    "gelu_new" / "gelu_pytorch_tanh" the tanh approximation."""
    tanh_gelu = lambda x: F.gelu(x, approximate="tanh")  # noqa: E731
    return {
        "gelu": F.gelu,
        "gelu_new": tanh_gelu,
        "gelu_pytorch_tanh": tanh_gelu,
        "relu": F.relu,
        "silu": F.silu,
    }.get(name, F.gelu)


# ---------------------------------------------------------------------------
# Layers (names and layouts of their Flax counterparts)
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """`flax.linen.Dense`: kernel [in, out] and bias held in `dtype`; the
    input is cast to it and the result returned in it."""

    def __init__(self, in_f, out_f, dtype, use_bias=True, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_f, out_f, dtype=dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_f, dtype=dtype, device=device))
            if use_bias
            else None
        )

    def forward(self, x):
        y = torch.matmul(x.to(self.kernel.dtype), self.kernel)
        return y if self.bias is None else y + self.bias


def _int8_matmul(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """[m, k] int8 x [k, n] int8 -> [m, n] int32 through `torch._int_mm`.
    On the card its operands must have more than 16 rows and k, n multiples
    of 8: rows are padded to a multiple of 32 (zero rows, sliced off), k and
    n with zeros (which add nothing to a dot)."""
    if not xq.is_cuda:
        return torch._int_mm(xq, kq)
    m, k = xq.shape
    n = kq.shape[1]
    m_pad, k_pad, n_pad = -(-m // 32) * 32, -(-k // 8) * 8, -(-n // 8) * 8
    if (m_pad, k_pad) != (m, k):
        xq = F.pad(xq, (0, k_pad - k, 0, m_pad - m))
    if (k_pad, n_pad) != (k, n):
        kq = F.pad(kq, (0, n_pad - n, 0, k_pad - k))
    return torch._int_mm(xq, kq)[:m, :n]


class QuantDense(nn.Module):
    """Dense with int8 weights + per-output-column scales and dynamic
    per-row int8 activation quantization (int8 x int8 -> int32), the JAX
    package's `QuantDense` (next-plaid-onnx's INT8 sessions: onnxruntime
    `quantize_dynamic`)."""

    def __init__(self, in_f, out_f, compute_dtype, use_bias=True, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        # Column-major [in, out]: the layout cuBLASLt's int8 product takes.
        self.register_buffer(
            "kernel_q", torch.zeros(out_f, in_f, dtype=torch.int8, device=device).t()
        )
        self.register_buffer(
            "kernel_scale", torch.ones(out_f, dtype=torch.float32, device=device)
        )
        self.bias = (
            nn.Parameter(torch.zeros(out_f, dtype=torch.float32, device=device))
            if use_bias
            else None
        )

    def forward(self, x):
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True)
        ascale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        xq = torch.clamp(torch.round(xf / ascale), -127, 127).to(torch.int8)
        lead = xq.shape[:-1]
        y = _int8_matmul(xq.reshape(-1, xq.shape[-1]), self.kernel_q)
        out = y.reshape(*lead, -1).float() * ascale * self.kernel_scale
        if self.bias is not None:
            out = out + self.bias
        return out.to(self.compute_dtype)


def _dense(quantized, in_f, out_f, dtype, use_bias=True, device=None):
    if quantized:
        return QuantDense(in_f, out_f, dtype, use_bias=use_bias, device=device)
    return Dense(in_f, out_f, dtype, use_bias=use_bias, device=device)


class Embed(nn.Module):
    """`flax.linen.Embed`: a float32 table named `embedding`."""

    def __init__(self, num, features, device=None):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(num, features, dtype=torch.float32, device=device)
        )

    def forward(self, ids):
        return F.embedding(ids, self.embedding)


class LayerNorm(nn.Module):
    """`flax.linen.LayerNorm(dtype=float32)`: `scale` and optional `bias`,
    run and returned in float32."""

    def __init__(self, features, eps, use_bias=True, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(features, device=device)) if use_bias else None
        )

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)


def _mask_bias(allow: torch.Tensor) -> torch.Tensor:
    """Additive float32 attention bias: 0 where allowed, -1e9 elsewhere."""
    return torch.where(allow, 0.0, -1e9).to(torch.float32)


def _attend(q, k, v, bias):
    """Plain attention over [B, L, H, D] q/k/v with a float32 additive bias
    broadcast to [B, H, L, L]; returns [B, L, H*D] float32."""
    B, L, H, D = q.shape
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(D)
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = torch.matmul(probs, v.float())
    return ctx.transpose(1, 2).reshape(B, L, H * D)


# ---------------------------------------------------------------------------
# Layouts: how a layer's attention sees its tokens (padded or packed)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inv_freq(theta: float, d: int, pinned: bool) -> torch.Tensor:
    """theta^(-2i / d) for i < d / 2, float32 on the host, built once per
    (theta, d); pinned for the copy to a card, which then waits for nothing
    queued. Nothing writes it after, so every copy reads the same values."""
    inv_freq = torch.from_numpy((1.0 / (theta ** (np.arange(0, d, 2) / d))).astype(np.float32))
    return inv_freq.pin_memory() if pinned else inv_freq


def _rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos and sin [*positions.shape, d / 2] float32 of the rotary angles
    position * theta^(-2i / d)."""
    inv_freq = _inv_freq(float(theta), int(d), positions.is_cuda)
    angles = positions.to(torch.float32)[..., None] * inv_freq.to(positions.device, non_blocking=True)
    return torch.cos(angles), torch.sin(angles)


def _rope(q, k, theta: float):
    """Rotary position embedding over the last dim of [B, L, H, D] q/k,
    rotate-half convention, computed in float32 and returned in q's dtype."""
    pos = torch.arange(q.shape[1], device=q.device)
    cos, sin = (t[None, :, None, :] for t in _rope_tables(pos, q.shape[-1], theta))
    return rotate_half(q, cos, sin), rotate_half(k, cos, sin)


def packed_positions(lengths) -> np.ndarray:
    """Each packed token's position in its own document: 0 .. L - 1 for
    every document of `lengths`, laid end to end (int64)."""
    lengths = np.asarray(lengths, np.int64)
    starts = np.cumsum(lengths) - lengths
    return np.arange(int(lengths.sum()), dtype=np.int64) - np.repeat(starts, lengths)


class _Padded:
    """Attention over a padded [B, L] batch, the JAX chain: positions
    0 .. L - 1 on every row, dense scores with a float32 mask bias that
    drops padded keys, and on a windowed layer (ModernBERT's local ones,
    `half_window` wide) the keys outside the window too."""

    def __init__(self, attention_mask: torch.Tensor, half_window: Optional[int] = None):
        allow = attention_mask.bool()[:, None, None, :]
        self.global_bias = _mask_bias(allow)
        self.half_window = half_window
        if half_window is not None:
            idx = torch.arange(attention_mask.shape[1], device=attention_mask.device)
            window = (idx[:, None] - idx[None, :]).abs() <= half_window
            self.local_bias = _mask_bias(allow & window[None, None, :, :])

    def attend(self, q, k, v, half_window, theta):
        """q, k, v [B, L, H, D] -> [B, L, H * D] float32; RoPE at `theta`
        unless it is None (absolute positions)."""
        if half_window not in (None, self.half_window):
            raise ValueError(f"the padded path's window is {self.half_window}, not {half_window}")
        if theta is not None:
            q, k = _rope(q, k, theta)
        return _attend(q, k, v, self.global_bias if half_window is None else self.local_bias)


class _Packed:
    """Attention over packed live tokens [N]: RoPE at each token's position
    in its own document and attention within each document of
    `cu_seqlens`, both in `ops.attention.varlen_attention` (the kernel on
    the card). Builds nothing of [L, L]."""

    def __init__(self, positions: torch.Tensor, cu_seqlens: torch.Tensor):
        self.positions, self.cu_seqlens = positions, cu_seqlens
        self._tables: Dict[float, tuple] = {}
        self._tiles = None

    def attend(self, q, k, v, half_window, theta):
        """q, k, v [N, H, D] -> [N, H * D] in q's dtype; RoPE at `theta`
        unless it is None (absolute positions)."""
        n, h, d = q.shape
        if theta is not None and theta not in self._tables:
            self._tables[theta] = _rope_tables(self.positions, d, theta)
        if self._tiles is None and q.is_cuda:
            self._tiles = tile_table(self.cu_seqlens, n)
        ctx = varlen_attention(q, k, v, self.cu_seqlens, half_window, 1.0 / math.sqrt(d),
                               rope=self._tables.get(theta), tiles=self._tiles)
        return ctx.reshape(n, h * d)


# ---------------------------------------------------------------------------
# BERT family (post-LayerNorm): absolute positions, or rotary on every layer
# ---------------------------------------------------------------------------


class BertSelfAttention(nn.Module):
    """Every token of a document attends to every other. Absolute BERT
    projects Q, K and V by three dense layers (HF's and the JAX package's
    names); the rotary kind by one fused, biased `Wqkv` (Jina's flash
    XLM-RoBERTa) and rotates q and k at `rotary_emb_base`."""

    def __init__(self, cfg: BackboneConfig, dtype, quantized, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.theta = cfg.rotary_emb_base if cfg.rotary else None
        if self.theta is None:
            for name in ("query", "key", "value"):
                self.add_module(name, _dense(quantized, h, h, dtype, device=device))
        else:
            self.Wqkv = _dense(quantized, h, 3 * h, dtype, device=device)
        self.output = _dense(quantized, h, h, dtype, device=device)

    def forward(self, hidden, layout):
        """hidden [B, L, h] with a `_Padded` layout or [N, h] with a
        `_Packed` one."""
        H = self.cfg.num_attention_heads
        lead, D = hidden.shape[:-1], self.cfg.hidden_size // H
        if self.theta is None:
            q, k, v = (getattr(self, n)(hidden).reshape(*lead, H, D) for n in ("query", "key", "value"))
        else:
            q, k, v = self.Wqkv(hidden).reshape(*lead, 3 * H, D).split(H, dim=-2)
        return self.output(layout.attend(q, k, v, None, self.theta))  # every layer global


class BertLayer(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype, quantized, device=None):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg, dtype, quantized, device)
        self.attention_norm = LayerNorm(h, eps, device=device)
        self.intermediate = _dense(quantized, h, cfg.intermediate_size, dtype, device=device)
        self.output = _dense(quantized, cfg.intermediate_size, h, dtype, device=device)
        self.output_norm = LayerNorm(h, eps, device=device)

    def forward(self, hidden, layout):
        hidden = self.attention_norm(hidden + self.attention(hidden, layout))
        mlp = self.output(self.act(self.intermediate(hidden)))
        return self.output_norm(hidden + mlp)


class BertBackbone(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype, quantized, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h, device)
        self.position_embeddings = (
            None if cfg.rotary else Embed(cfg.max_position_embeddings, h, device)
        )
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h, device)
        self.embeddings_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, dtype, quantized, device))

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        """[B, L] ids and mask -> [B, L, h] float32: the JAX chain
        (`_Padded`), on any device."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        return self._layers(self._embed(input_ids, pos, token_type_ids),
                            _Padded(attention_mask))

    def forward_packed(self, input_ids, positions, cu_seqlens):
        """[N] live token ids of documents laid end to end, each token's
        position in its document [N] and cu_seqlens [B + 1] int32 ->
        [N, h] float32, token type 0 throughout."""
        return self._layers(self._embed(input_ids, positions, None),
                            _Packed(positions, cu_seqlens))

    def _embed(self, input_ids, positions, token_type_ids):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.word_embeddings(input_ids)
        if self.position_embeddings is not None:
            emb = emb + self.position_embeddings(positions)
        return self.embeddings_norm(emb + self.token_type_embeddings(token_type_ids))

    def _layers(self, hidden, layout):
        for i in range(self.cfg.num_hidden_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, layout)
        return hidden


# ---------------------------------------------------------------------------
# ModernBERT backbone (RoPE, GeGLU, pre-norm, local/global alternation)
# ---------------------------------------------------------------------------


class ModernBertAttention(nn.Module):
    def __init__(self, cfg: BackboneConfig, layer_idx, dtype, quantized, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        # Local layers: |i - j| <= window / 2; global layers: None.
        self.half_window = cfg.layer_windows()[layer_idx]
        self.is_global = self.half_window is None
        self.theta = cfg.global_rope_theta if self.is_global else cfg.local_rope_theta
        self.Wqkv = _dense(quantized, h, 3 * h, dtype, use_bias=False, device=device)
        self.Wo = _dense(quantized, h, h, dtype, use_bias=False, device=device)

    def forward(self, hidden, layout):
        """hidden [B, L, h] with a `_Padded` layout or [N, h] with a
        `_Packed` one."""
        cfg = self.cfg
        H = cfg.num_attention_heads
        qkv = self.Wqkv(hidden).reshape(*hidden.shape[:-1], 3 * H, cfg.hidden_size // H)
        q, k, v = qkv.split(H, dim=-2)
        return self.Wo(layout.attend(q, k, v, self.half_window, self.theta))


class ModernBertLayer(nn.Module):
    def __init__(self, cfg: BackboneConfig, layer_idx, dtype, quantized, device=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.norm_eps
        self.act = _act(cfg.hidden_act)
        # HF ModernBERT's layer 0 has an Identity attn_norm: the embedding
        # norm directly precedes it.
        self.attn_norm = (
            LayerNorm(h, eps, use_bias=False, device=device) if layer_idx else None
        )
        self.attn = ModernBertAttention(cfg, layer_idx, dtype, quantized, device)
        self.mlp_norm = LayerNorm(h, eps, use_bias=False, device=device)
        self.Wi = _dense(
            quantized, h, 2 * cfg.intermediate_size, dtype, use_bias=False, device=device
        )
        self.Wo = _dense(
            quantized, cfg.intermediate_size, h, dtype, use_bias=False, device=device
        )

    def forward(self, hidden, layout):
        normed = hidden if self.attn_norm is None else self.attn_norm(hidden)
        hidden = hidden + self.attn(normed, layout)
        a, b = self.Wi(self.mlp_norm(hidden)).chunk(2, dim=-1)  # GeGLU
        return hidden + self.Wo(self.act(a) * b)


class ModernBertBackbone(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype, quantized, device=None):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.norm_eps
        self.word_embeddings = Embed(cfg.vocab_size, h, device)
        self.emb_norm = LayerNorm(h, eps, use_bias=False, device=device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(
                f"layer_{i}", ModernBertLayer(cfg, i, dtype, quantized, device)
            )
        self.final_norm = LayerNorm(h, eps, use_bias=False, device=device)

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        """[B, L] ids and mask -> [B, L, h] float32: the JAX chain
        (`_Padded`), on any device. The encoder runs `forward_packed`."""
        return self._layers(self.word_embeddings(input_ids),
                            _Padded(attention_mask, self.cfg.local_attention // 2))

    def forward_packed(self, input_ids, positions, cu_seqlens):
        """[N] live token ids of documents laid end to end, each token's
        position in its document [N] and cu_seqlens [B + 1] int32 ->
        [N, h] float32 (HF ModernBERT's unpadded path)."""
        return self._layers(self.word_embeddings(input_ids), _Packed(positions, cu_seqlens))

    def _layers(self, emb, layout):
        hidden = self.emb_norm(emb)
        for i in range(self.cfg.num_hidden_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, layout)
        return self.final_norm(hidden)


# ---------------------------------------------------------------------------
# ColBERT head
# ---------------------------------------------------------------------------


class ColbertModel(nn.Module):
    """Backbone -> Dense(projection_dim, no bias, float32) -> L2 normalize.

    `compute_dtype` is the backbone's dense and attention-product dtype
    (bfloat16 by default, float32 for tight parity). quantized=True swaps
    every backbone dense layer for QuantDense (int8 weights, dynamic int8
    activations); the projection stays full precision. Parameters are
    created uninitialised on `device` ("cuda" when None): load a state_dict
    into them."""

    def __init__(
        self,
        config: BackboneConfig,
        compute_dtype: torch.dtype = torch.bfloat16,
        quantized: bool = False,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        backbone = (
            ModernBertBackbone if config.model_type == "modernbert" else BertBackbone
        )
        self.backbone = backbone(config, compute_dtype, quantized, device)
        self.projection = Dense(
            config.hidden_size, config.projection_dim, torch.float32,
            use_bias=False, device=device,
        )

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        return self._head(self.backbone(input_ids, attention_mask, token_type_ids))

    def forward_packed(self, input_ids, positions, cu_seqlens):
        """The packed forward (the backbone's `forward_packed`) ->
        [N, projection_dim] float32, L2-normalized."""
        return self._head(self.backbone.forward_packed(input_ids, positions, cu_seqlens))

    def _head(self, hidden):
        proj = self.projection(hidden.float())
        return proj / torch.clamp(proj.norm(dim=-1, keepdim=True), min=1e-12)


# ---------------------------------------------------------------------------
# Weights: random init, the JAX package's trees, quantization, HF checkpoints
# ---------------------------------------------------------------------------


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax param tree (`{"params": {...}}` with numpy or
    jax leaves, float and `kernel_q`/`kernel_scale`) as this module's
    state_dict: the same names joined by dots, the same layouts."""
    tree = tree.get("params", tree)
    return {
        name: torch.from_numpy(np.array(leaf))
        for name, leaf in _flatten(tree).items()
    }


def init_random_params(cfg: BackboneConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random float32 weights from `seed` (tests and runs without a
    checkpoint), drawn on the host by an explicit `torch.Generator` with
    the Flax initializers' distributions: dense kernels LeCun normal
    (truncated at two deviations, variance 1/fan_in), embeddings normal
    with variance 1/features, norms' scales ones, biases zeros."""
    gen = torch.Generator().manual_seed(seed)
    model = ColbertModel(cfg, torch.float32, device="meta")
    out = {}
    for name, p in model.state_dict().items():
        leaf = name.rsplit(".", 1)[1]
        t = torch.empty(p.shape, dtype=torch.float32)
        if leaf == "kernel":
            # Flax's truncated_normal rescales so the truncated variance is 1.
            std = math.sqrt(1.0 / p.shape[0]) / 0.87962566103423978
            nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)
        elif leaf == "embedding":
            nn.init.normal_(t, std=math.sqrt(1.0 / p.shape[1]), generator=gen)
        elif leaf == "scale":
            t.fill_(1.0)
        else:
            t.zero_()
        out[name] = t
    return out


def quantize_dense_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Post-training conversion of a float state_dict: every 2-D dense
    kernel but the projection's becomes int8 weights + per-output-column
    float32 scales for QuantDense (the JAX package's arithmetic, in numpy),
    with its bias in float32. The projection stays full precision: it is
    tiny and sets output quality."""
    out = {}
    for name, value in params.items():
        parts = name.split(".")
        prefix = ".".join(parts[:-1])
        skip = parts[0] == "projection"
        if parts[-1] == "kernel" and value.ndim == 2 and not skip:
            w = value.detach().cpu().float().numpy()
            s = np.abs(w).max(axis=0) / 127.0
            s = np.where(s > 0, s, 1.0).astype(np.float32)
            q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
            out[f"{prefix}.kernel_q"] = torch.from_numpy(q)
            out[f"{prefix}.kernel_scale"] = torch.from_numpy(s)
        elif parts[-1] == "bias" and f"{prefix}.kernel" in params and not skip:
            out[name] = value.detach().float()
        else:
            out[name] = value
    return out


def _read_state_dict(model_dir: Path) -> Dict[str, np.ndarray]:
    st = model_dir / "model.safetensors"
    if st.exists():
        from safetensors.numpy import load_file

        return load_file(str(st))
    pt = model_dir / "pytorch_model.bin"
    if pt.exists():
        sd = torch.load(str(pt), map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise EncodingError(f"No model.safetensors or pytorch_model.bin in {model_dir}")


def _read_dense_head(model_dir: Path) -> Optional[np.ndarray]:
    """PyLate/sentence-transformers store the ColBERT projection in a
    `1_Dense/` module directory."""
    for rel in ("1_Dense/model.safetensors", "1_Dense/pytorch_model.bin"):
        p = model_dir / rel
        if not p.exists():
            continue
        if p.suffix == ".safetensors":
            from safetensors.numpy import load_file

            sd = load_file(str(p))
        else:
            sd = {
                k: v.float().numpy()
                for k, v in torch.load(str(p), map_location="cpu", weights_only=True).items()
            }
        for key in ("linear.weight", "dense.weight", "weight"):
            if key in sd:
                return np.asarray(sd[key])
    return None


def _strip_prefix(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    for prefix in ("bert.", "roberta.", "model.", "encoder_model."):
        if any(k.startswith(prefix) for k in sd):
            return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def _kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _hf_dense(sd: Dict[str, np.ndarray], name: str) -> Dict:
    return {"kernel": _kernel(sd[name + ".weight"]), "bias": sd[name + ".bias"]}


def _hf_norm(sd: Dict[str, np.ndarray], name: str) -> Dict:
    return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}


def _map_bert(sd: Dict[str, np.ndarray], cfg: BackboneConfig) -> Dict:
    """HF bert-* names -> the BertBackbone tree (nested, as the JAX
    package's)."""
    p: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "position_embeddings": {"embedding": sd["embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embeddings_norm": {
            "scale": sd["embeddings.LayerNorm.weight"],
            "bias": sd["embeddings.LayerNorm.bias"],
        },
    }
    dense, norm = functools.partial(_hf_dense, sd), functools.partial(_hf_norm, sd)
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layer.{i}."
        p[f"layer_{i}"] = {
            "attention": {
                "query": dense(b + "attention.self.query"),
                "key": dense(b + "attention.self.key"),
                "value": dense(b + "attention.self.value"),
                "output": dense(b + "attention.output.dense"),
            },
            "attention_norm": norm(b + "attention.output.LayerNorm"),
            "intermediate": dense(b + "intermediate.dense"),
            "output": dense(b + "output.dense"),
            "output_norm": norm(b + "output.LayerNorm"),
        }
    return p


def _map_xlmr_rotary(sd: Dict[str, np.ndarray], cfg: BackboneConfig) -> Dict:
    """Jina's flash XLM-RoBERTa names (under `roberta.`, stripped) -> the
    rotary BertBackbone tree: no position table, a fused biased `Wqkv`."""
    dense, norm = functools.partial(_hf_dense, sd), functools.partial(_hf_norm, sd)
    p: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd["embeddings.word_embeddings.weight"]},
        "token_type_embeddings": {"embedding": sd["embeddings.token_type_embeddings.weight"]},
        "embeddings_norm": norm("emb_ln"),
    }
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layers.{i}."
        p[f"layer_{i}"] = {
            "attention": {"Wqkv": dense(b + "mixer.Wqkv"), "output": dense(b + "mixer.out_proj")},
            "attention_norm": norm(b + "norm1"),
            "intermediate": dense(b + "mlp.fc1"),
            "output": dense(b + "mlp.fc2"),
            "output_norm": norm(b + "norm2"),
        }
    return p


def _map_modernbert(sd: Dict[str, np.ndarray], cfg: BackboneConfig) -> Dict:
    p: Dict[str, Any] = {
        "word_embeddings": {"embedding": sd["embeddings.tok_embeddings.weight"]},
        "emb_norm": {"scale": sd["embeddings.norm.weight"]},
        "final_norm": {"scale": sd["final_norm.weight"]},
    }
    for i in range(cfg.num_hidden_layers):
        b = f"layers.{i}."
        layer: Dict[str, Any] = {
            "attn": {
                "Wqkv": {"kernel": _kernel(sd[b + "attn.Wqkv.weight"])},
                "Wo": {"kernel": _kernel(sd[b + "attn.Wo.weight"])},
            },
            "mlp_norm": {"scale": sd[b + "mlp_norm.weight"]},
            "Wi": {"kernel": _kernel(sd[b + "mlp.Wi.weight"])},
            "Wo": {"kernel": _kernel(sd[b + "mlp.Wo.weight"])},
        }
        if i != 0:
            layer["attn_norm"] = {"scale": sd[b + "attn_norm.weight"]}
        p[f"layer_{i}"] = layer
    return p


def load_params(model_dir, cfg: BackboneConfig) -> Dict[str, torch.Tensor]:
    """Load an HF checkpoint (and its `1_Dense/` projection) as a
    ColbertModel state_dict."""
    model_dir = Path(model_dir)
    sd = _strip_prefix(_read_state_dict(model_dir))
    if cfg.model_type == "modernbert":
        backbone = _map_modernbert(sd, cfg)
    elif cfg.rotary:
        backbone = _map_xlmr_rotary(sd, cfg)
    elif cfg.model_type in ("roberta", "xlm-roberta"):
        # BERT's names, but positions counted from past the padding id.
        raise EncodingError(
            f"{cfg.model_type} with absolute positions is not supported; "
            "the rotary XLM-RoBERTa (position_embedding_type: rotary) is"
        )
    else:
        backbone = _map_bert(sd, cfg)
    head = _read_dense_head(model_dir)
    if head is None:
        # Some exports keep the projection in the main state dict.
        for key in ("linear.weight", "projection.weight", "dense.weight"):
            if key in sd:
                head = sd[key]
                break
    if head is None:
        raise EncodingError(
            f"ColBERT projection weights not found in {model_dir} "
            "(expected 1_Dense/ module or linear.weight)"
        )
    return params_from_jax(
        {"backbone": backbone, "projection": {"kernel": _kernel(np.asarray(head))}}
    )
