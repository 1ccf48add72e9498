"""Attention over packed documents of unequal length, global or in a
sliding window: ModernBERT's attention in the port's packed encoder forward
(`encoder.model`), one Triton kernel on the card.

`varlen_attention(q, k, v, cu_seqlens, half_window, scale)` takes q, k, v
[N, H, D], the live tokens of B documents laid end to end (document b at
rows cu_seqlens[b]:cu_seqlens[b + 1], cu_seqlens [B + 1] int32 from 0 to
N). Token i of a document attends to token j of the same document, never
of another: every j when `half_window` is None (a global layer), and
|i - j| <= half_window otherwise (a local layer). With `rope`, each
token's rotary cos and sin, q and k are first rotated (rotate-half, in
float32, rounded to q's dtype). It returns softmax(scale * q k^T) v as
[N, H, D] in q's dtype.

Why it was added. It replaces no Pallas kernel: the JAX package computes
ModernBERT's attention in plain XLA as dense [B, H, L, L] float32 scores
plus a [B, 1, L, L] float32 mask bias, local layers too, over a batch
padded to its longest document (`encoder.model`'s padded path, the chain
the CPU tests hold, still does). At GTE-ModernColBERT-v1's 8,192 positions
that is 3.2 GB of scores a document a layer, and a forward of 32 documents
padded to its longest does not fit the card.

What bounds it, on an H100 (989 TFLOP/s bf16, 3.35 TB/s). A global layer
over a document of L tokens needs 4 L^2 H D operations for 8 L H D bytes of
q, k, v and output (bf16): L / 2 operations a byte, so past ~600 tokens the
tensor cores bound it. A local layer's band needs about 4 L (2w + 1) H D
operations for the same bytes: at w = 64, ~64 a byte, under the card's
~295, so device memory bounds it.

Design. One program computes one tile of BLOCK_M query rows of one
document for one head, flash-style: the key and value tiles of BLOCK_N
rows are visited in turn, the whole document on a global layer and only
the tiles that meet the band on a local one; scores and probabilities live
in registers under an online float32 softmax (running max and sum), and
nothing of [L, L] reaches device memory. Q K^T and P V run on the tensor
cores in q's dtype with float32 accumulation (float32 inputs in IEEE
float32). RoPE is applied to each q tile once and to each k tile as it
is loaded, from per-token float32 tables, so rotated copies of q and k
never reach device memory; q and k are loaded in halves, the pairs RoPE
rotates, and Q K^T is two products of depth D / 2 into one accumulator.
A tile never crosses a document's end: the programs walk a table
of (document, tile) built on the card from cu_seqlens, without a host
sync, sized for the most tiles N tokens in B documents can have; the
surplus programs return at once. Tiles are launched from the table's end,
since the encoder packs documents in ascending length, so the longest
documents' programs start first.

Departure from the JAX chain: the chain multiplies the float32
probabilities by the values in float32; the kernel rounds P to q's dtype
(bf16) before P V, with float32 accumulation. The plain version below
keeps the chain's float32 product; tests hold the kernel to it at the bf16
bound of the encoder's tests.

`varlen_attention_reference` is the plain version: what CPU tensors take,
one document at a time, with the band as an explicit mask. CUDA tensors
take the kernel or raise. `varlen_attention.launches` counts launches.
Triton is imported, and the kernel built, at the first launch.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Tuple

import torch

BLOCK_M = 128  # query rows a program
BLOCK_N = 64  # key rows a step
NUM_WARPS = 4
NUM_STAGES = 3
HEAD_DIMS = (32, 64, 128)  # halves of at least 16, the least depth tl.dot takes
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_COUNT_LOCK = threading.Lock()  # the encoder pool runs forwards from threads


def _check(q, k, v, cu_seqlens, half_window, rope=None) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [N, H, D] alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share a dtype of {DTYPES}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if cu_seqlens.dtype != torch.int32 or cu_seqlens.dim() != 1 or cu_seqlens.numel() < 1:
        raise ValueError("cu_seqlens must be a 1-D int32 tensor [B + 1]")
    for name, t in (("k", k), ("v", v), ("cu_seqlens", cu_seqlens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if half_window is not None and half_window < 0:
        raise ValueError(f"half_window must be None or >= 0, got {half_window}")
    if rope is not None:
        for name, t in zip(("cos", "sin"), rope):
            if t.shape != (q.shape[0], q.shape[2] // 2) or t.dtype != torch.float32:
                raise ValueError(f"rope {name} must be [N, D / 2] float32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device != q.device:
                raise ValueError(f"rope {name} is on {t.device}, q on {q.device}")


def rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE of x's last dim: [x1 cos - x2 sin, x2 cos + x1 sin]
    computed in float32 (cos, sin broadcast against either half), returned
    in x's dtype. The JAX chain's arithmetic."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def varlen_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens: torch.Tensor,
    half_window: Optional[int],
    scale: float,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """The plain version: the JAX chain's arithmetic one document at a time
    (RoPE by `rotate_half`, the product in q's dtype, then float32 scores,
    mask, softmax and a float32 product with the values), returned in q's
    dtype."""
    _check(q, k, v, cu_seqlens, half_window, rope)
    if rope is not None:
        cos, sin = (t[:, None, :] for t in rope)
        q, k = rotate_half(q, cos, sin), rotate_half(k, cos, sin)
    out = torch.empty_like(q)
    bounds = cu_seqlens.tolist()
    for s, e in zip(bounds[:-1], bounds[1:]):
        if e <= s:
            continue
        qd, kd, vd = (t[s:e].transpose(0, 1) for t in (q, k, v))  # [H, L, D]
        scores = torch.matmul(qd, kd.transpose(-1, -2)).float() * scale
        if half_window is not None:
            idx = torch.arange(e - s, device=q.device)
            band = (idx[:, None] - idx[None, :]).abs() <= half_window
            scores = scores.masked_fill(~band, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[s:e] = torch.matmul(probs, vd.float()).transpose(0, 1).to(q.dtype)
    return out


def tile_table(cu_seqlens: torch.Tensor, n_tokens: int):
    """(tile_doc, cu_tiles, programs): for each program slot t, the
    document its tile lies in (slots past the real tiles name document B);
    each document's first slot; and the number of slots, the most tiles N
    tokens in B documents can have (N / BLOCK_M + B). Built on the card
    without a host sync."""
    n_docs = cu_seqlens.numel() - 1
    lens = cu_seqlens[1:] - cu_seqlens[:-1]
    cu_tiles = torch.zeros(n_docs + 1, dtype=torch.int32, device=cu_seqlens.device)
    cu_tiles[1:] = torch.cumsum((lens + BLOCK_M - 1) // BLOCK_M, 0)
    programs = -(-n_tokens // BLOCK_M) + n_docs
    slots = torch.arange(programs, dtype=torch.int32, device=cu_seqlens.device)
    tile_doc = torch.searchsorted(cu_tiles, slots, right=True, out_int32=True) - 1
    return tile_doc, cu_tiles, programs


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def varlen_attention_kernel(
        Q, K, V, O, COS, SIN, CU, TILE_DOC, CU_TILES,
        n_docs, programs, qk_scale,
        sq_t, sq_h, sk_t, sk_h, sv_t, sv_h, so_t, so_h,
        HALF_WINDOW: tl.constexpr, LOCAL: tl.constexpr, ROPE: tl.constexpr,
        IEEE: tl.constexpr, HEADS: tl.constexpr, D: tl.constexpr,
        BM: tl.constexpr, BN: tl.constexpr,
    ):
        HD: tl.constexpr = D // 2  # q and k are loaded in halves, as RoPE pairs them
        pid = tl.program_id(0)
        slot = programs - 1 - pid // HEADS  # the table's end first
        head = pid % HEADS
        doc = tl.load(TILE_DOC + slot)
        if doc < n_docs:
            start = tl.load(CU + doc)
            length = tl.load(CU + doc + 1) - start
            m0 = (slot - tl.load(CU_TILES + doc)) * BM
            offs_m = m0 + tl.arange(0, BM)
            offs_h = tl.arange(0, HD)
            offs_d = tl.arange(0, D)
            row_ok = offs_m < length
            rows_m = (start + offs_m).to(tl.int64)
            q_ptr = Q + rows_m[:, None] * sq_t + head * sq_h + offs_h[None, :]
            q1 = tl.load(q_ptr, mask=row_ok[:, None], other=0.0)
            q2 = tl.load(q_ptr + HD, mask=row_ok[:, None], other=0.0)
            if ROPE:  # rotate-half in float32, rounded to q's dtype
                t_ptr = rows_m[:, None] * HD + offs_h[None, :]
                c = tl.load(COS + t_ptr, mask=row_ok[:, None], other=0.0)
                sn = tl.load(SIN + t_ptr, mask=row_ok[:, None], other=0.0)
                a = q1.to(tl.float32)
                b = q2.to(tl.float32)
                q1 = (a * c - b * sn).to(Q.dtype.element_ty)
                q2 = (b * c + a * sn).to(Q.dtype.element_ty)
            if LOCAL:
                lo = tl.maximum(m0 - HALF_WINDOW, 0) // BN * BN
                hi = tl.minimum(m0 + BM + HALF_WINDOW, length)
            else:
                lo = 0
                hi = length
            m_i = tl.full([BM], -1.0e30, tl.float32)  # finite: a row may meet no key in a tile
            l_i = tl.zeros([BM], tl.float32)
            acc = tl.zeros([BM, D], tl.float32)
            for n0 in range(lo, hi, BN):
                offs_n = n0 + tl.arange(0, BN)
                col_ok = offs_n < length
                rows_n = (start + offs_n).to(tl.int64)
                k_ptr = K + rows_n[:, None] * sk_t + head * sk_h + offs_h[None, :]
                k1 = tl.load(k_ptr, mask=col_ok[:, None], other=0.0)
                k2 = tl.load(k_ptr + HD, mask=col_ok[:, None], other=0.0)
                if ROPE:  # fresh names: a name set before the loop would be loop-carried
                    tk_ptr = rows_n[:, None] * HD + offs_h[None, :]
                    ck = tl.load(COS + tk_ptr, mask=col_ok[:, None], other=0.0)
                    sk = tl.load(SIN + tk_ptr, mask=col_ok[:, None], other=0.0)
                    ka = k1.to(tl.float32)
                    kb = k2.to(tl.float32)
                    k1 = (ka * ck - kb * sk).to(K.dtype.element_ty)
                    k2 = (kb * ck + ka * sk).to(K.dtype.element_ty)
                v = tl.load(V + rows_n[:, None] * sv_t + head * sv_h + offs_d[None, :],
                            mask=col_ok[:, None], other=0.0)
                if IEEE:
                    s = tl.dot(q1, tl.trans(k1), input_precision="ieee")
                    s = tl.dot(q2, tl.trans(k2), acc=s, input_precision="ieee")
                else:
                    s = tl.dot(q1, tl.trans(k1))
                    s = tl.dot(q2, tl.trans(k2), acc=s)
                s = s * qk_scale
                ok = col_ok[None, :]
                if LOCAL:
                    dist = offs_m[:, None] - offs_n[None, :]
                    ok = ok & (dist <= HALF_WINDOW) & (dist >= -HALF_WINDOW)
                s = tl.where(ok, s, float("-inf"))
                m_new = tl.maximum(m_i, tl.max(s, 1))
                alpha = tl.exp2(m_i - m_new)
                p = tl.exp2(s - m_new[:, None])
                l_i = l_i * alpha + tl.sum(p, 1)
                if IEEE:
                    pv = tl.dot(p, v, input_precision="ieee")
                else:
                    pv = tl.dot(p.to(v.dtype), v)
                acc = acc * alpha[:, None] + pv
                m_i = m_new
            acc = acc / l_i[:, None]
            tl.store(O + rows_m[:, None] * so_t + head * so_h + offs_d[None, :],
                     acc.to(O.dtype.element_ty), mask=row_ok[:, None])

    return varlen_attention_kernel


def varlen_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cu_seqlens: torch.Tensor,
    half_window: Optional[int],
    scale: float,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tiles: Optional[tuple] = None,
) -> torch.Tensor:
    """softmax(scale q k^T) v within each document of the packed [N, H, D]
    q, k, v, over the band |i - j| <= half_window (None: every token of the
    document); [N, H, D] in q's dtype. `rope`, (cos, sin) [N, D / 2]
    float32 of each token's rotary angles: q and k are first rotated as
    `rotate_half` rotates them. `tiles`: `tile_table(cu_seqlens, N)`, for
    callers that launch several times over one packing. CPU tensors take
    the plain version; CUDA tensors one launch of the kernel on the
    current stream, or raise."""
    if q.device.type == "cpu":
        return varlen_attention_reference(q, k, v, cu_seqlens, half_window, scale, rope)
    _check(q, k, v, cu_seqlens, half_window, rope)
    if q.device.type != "cuda":
        raise ValueError(f"varlen_attention takes CPU or CUDA tensors, got {q.device}")
    n, heads, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} must be one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    out = torch.empty((n, heads, d), dtype=q.dtype, device=q.device)
    n_docs = cu_seqlens.numel() - 1
    if n == 0 or n_docs == 0:
        return out
    cu = cu_seqlens.contiguous()
    tile_doc, cu_tiles, programs = tile_table(cu, n) if tiles is None else tiles
    cos, sin = (q, q) if rope is None else (t.contiguous() for t in rope)
    kernel = _kernel()
    with torch.cuda.device(q.device):
        kernel[(programs * heads,)](
            q, k, v, out, cos, sin, cu, tile_doc, cu_tiles,
            n_docs, programs, float(scale) * 1.4426950408889634,  # log2(e): exp2 below
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            HALF_WINDOW=0 if half_window is None else int(half_window),
            LOCAL=half_window is not None, ROPE=rope is not None,
            IEEE=q.dtype == torch.float32, HEADS=heads, D=d, BM=BLOCK_M, BN=BLOCK_N,
            num_warps=NUM_WARPS, num_stages=NUM_STAGES,
        )
    with _COUNT_LOCK:
        varlen_attention.launches += 1
    return out


varlen_attention.launches = 0  # kernel launches since the last reset
