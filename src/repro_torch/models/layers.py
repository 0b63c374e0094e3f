"""LM layer primitives: norms, RoPE, chunked (flash-style) attention, GQA,
decode attention over KV caches.

Each function computes what its reference namesake (``repro.models.layers``)
computes, rounding to bf16 in the same places: score products run in f32
(the reference's ``preferred_element_type=float32``), softmax probabilities
are cast to the value dtype before P·V, and masks use ``NEG_INF = -1e30``,
not ``-inf``. The reference's sharding constraints have no counterpart on
one device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BF16 = torch.bfloat16
F32 = torch.float32
NEG_INF = -1e30


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them (bf16 with f32 computes in f32)."""
    dtype = ops[0].dtype
    for o in ops[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    return torch.einsum(eq, *(o.to(dtype) for o in ops))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split. x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]               # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int = 0, kv_chunk: int = 0,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention. q (B,Sq,H,dh); k,v (B,T,KV,dhk/dhv). Returns (B,Sq,H,dhv).

    kv_chunk > 0 runs a flash-style streaming softmax over KV chunks, so no
    (Sq, T) tensor larger than (Sq, kv_chunk) is materialized; T must be a
    multiple of ``kv_chunk``, as in the reference.
    """
    b, sq, h, dh = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(dh)
    k = _repeat_kv(k, h // n_kv)
    v = _repeat_kv(v, h // n_kv)
    qs = (q * float(scale)).to(q.dtype).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)

    if not kv_chunk or kv_chunk >= t:
        logits = einsum("bshd,bthd->bhst", qs, k.float())
        if causal:
            k_pos = torch.arange(t, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        return einsum("bhst,bthd->bshd", p.to(v.dtype), v)

    if t % kv_chunk:
        raise ValueError(f"attention: T={t} is not a multiple of "
                         f"kv_chunk={kv_chunk}")

    def body(m, l, acc, kc, vc, c0: int):
        logits = einsum("bshd,bthd->bhst", qs, kc.float())
        if causal:
            k_pos = c0 + torch.arange(kv_chunk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + einsum(
            "bhst,bthd->bhsd", p.to(vc.dtype), vc).float()
        return m_new, l_new, acc_new

    m = torch.full((b, h, sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=F32, device=q.device)
    acc = torch.zeros((b, h, sq, dhv), dtype=F32, device=q.device)
    # with grad on, each chunk is rematerialized, as the reference's
    # jax.checkpoint(body): the backward recomputes the chunk's logits
    # instead of keeping a (Sq, kv_chunk) score block per chunk
    remat = torch.is_grad_enabled()
    for c0 in range(0, t, kv_chunk):
        args = (m, l, acc, k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk], c0)
        if remat:
            m, l, acc = checkpoint(body, *args, use_reentrant=False)
        else:
            m, l, acc = body(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention over a KV cache.

    q (B,1,H,dh); caches (B,T,KV,dh*); ``length`` = number of valid
    positions. The scaled query stays f32, as the reference's product with
    a numpy scalar promotes it.
    """
    b, _, h, dh = q.shape
    t, n_kv = k_cache.shape[1], k_cache.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(dh)
    qg = q.reshape(b, n_kv, h // n_kv, dh).float() * float(scale)  # (B,KV,G,dh)
    logits = einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    pos = torch.arange(t, device=q.device)
    logits = torch.where((pos < length)[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


class _EmbedLookup(torch.autograd.Function):
    """Row gather whose backward adds the cotangent into zeros of the
    embedding's shape and dtype, as the reference's ``_embed_bwd``: no f32
    (vocab, d) buffer. Duplicate ids sum in that dtype, in index order on
    the CPU and by atomics in no fixed order on the card."""

    @staticmethod
    def forward(ctx, embed: torch.Tensor, tokens: torch.Tensor):
        ctx.save_for_backward(tokens)
        ctx.embed_shape, ctx.embed_dtype = embed.shape, embed.dtype
        return embed[tokens]

    @staticmethod
    def backward(ctx, dh: torch.Tensor):
        (tokens,) = ctx.saved_tensors
        demb = torch.zeros(ctx.embed_shape, dtype=ctx.embed_dtype,
                           device=dh.device)
        demb.index_add_(0, tokens.reshape(-1),
                        dh.reshape(-1, dh.shape[-1]).to(ctx.embed_dtype))
        return demb, None


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding row gather with the reference's custom backward: the
    cotangent is scatter-added in the embedding dtype (bf16)."""
    return _EmbedLookup.apply(embed, tokens)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = einsum("...d,df->...f", x, w_gate)
    u = einsum("...d,df->...f", x, w_up)
    act = F.silu(g) * u
    return einsum("...f,fd->...d", act, w_down).to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, vocab_valid: int) -> torch.Tensor:
    """Mean NLL over masked targets; padded vocab columns are excluded."""
    logits = logits.float()
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab_valid, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, targets[..., None].long())[..., 0]
    ll = lab - lse
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
