"""LM layer primitives: norms, RoPE, chunked (flash-style) attention, GQA,
decode attention over KV caches.

Each function computes what its reference namesake (``repro.models.layers``)
computes, rounding to bf16 in the same places: score products run in f32
(the reference's ``preferred_element_type=float32``), softmax probabilities
are cast to the value dtype before P·V, and masks use ``NEG_INF = -1e30``,
not ``-inf``. The reference's sharding constraints are kept at its sites
(``dist.sharding.shard_act``): on a registered mesh they redistribute the
DTensor activations, off-mesh they are the identity. Tensors made here
(positions, masks, accumulators) come from ``mesh_tensor``, so they land on
the mesh of the operand they meet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (all_reduce, concat_rows, mesh_tensor,
                                       model_axis_size, shard_act, whole)
from repro_torch.dist.sharding import einsum as sharded_einsum

BF16 = torch.bfloat16
F32 = torch.float32
NEG_INF = -1e30


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them (bf16 with f32 computes in f32); DTensor
    operands go through ``dist.sharding.einsum``."""
    dtype = ops[0].dtype
    for o in ops[1:]:
        dtype = torch.promote_types(dtype, o.dtype)
    ops = tuple(o.to(dtype) for o in ops)
    if isinstance(ops[0], DTensor):
        return sharded_einsum(eq, *ops)
    return torch.einsum(eq, *ops)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    # a DTensor's feature dim is made whole: its mean over a shard would be
    # a Partial(avg), whose gradient some torch releases cannot place
    x = whole(x, -1)
    xf = x.float()
    n = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (n * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split. x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    idx = mesh_tensor(x, lambda s: torch.arange(0, half, dtype=F32,
                                                device=x.device), (half,))
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions[..., None].float() * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]               # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    # q/k arrive (dp, -, model, -) head-sharded: the result keeps that
    labels = ("dp",) + (None,) * (x.ndim - 3) + ("model", None)
    out = concat_rows([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1,
                      labels=labels)
    return out.to(x.dtype)


def _attn_labels(h: int, sq: int):
    """The shardable dim of (B, H, Sq, T) attention intermediates: heads
    when they divide the model axis, else query positions."""
    msz = model_axis_size()
    if msz > 1 and h % msz == 0:
        return ("dp", "model", None, None)
    if msz > 1 and sq % msz == 0:
        return ("dp", None, "model", None)
    return ("dp", None, None, None)


def _arange(ref: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """``start + arange(n)`` on ``ref``'s device and mesh."""
    return mesh_tensor(ref, lambda s: start + torch.arange(
        n, device=ref.device), (n,))


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
    q_pos = _arange(q, sq, q_offset)
    lbl = _attn_labels(h, sq)
    if lbl[2] is not None:
        # heads that do not divide ``model``: the scores are sharded on the
        # query positions, so each rank computes only its rows of them (a
        # slice of the replicated query, no collective)
        qs = shard_act(qs, "dp", "model", None, None)

    if not kv_chunk or kv_chunk >= t:
        logits = shard_act(einsum("bshd,bthd->bhst", qs, k.float()), *lbl)
        if causal:
            k_pos = _arange(q, t)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        return einsum("bhst,bthd->bshd", p.to(v.dtype), v)

    if t % kv_chunk:
        raise ValueError(f"attention: T={t} is not a multiple of "
                         f"kv_chunk={kv_chunk}")

    # every tensor the chunk reads is an argument of ``body``, which closes
    # over Python values only: a checkpoint keeps its function until the
    # backward, so under the layer's own remat a tensor it closed over (the
    # query, replicated over ``model`` where the heads do not divide it)
    # would outlive the layer
    def body(qs, q_pos, m, l, acc, kc, vc, c0: int):
        logits = shard_act(einsum("bshd,bthd->bhst", qs, kc.float()), *lbl)
        if causal:
            k_pos = _arange(qs, kv_chunk, c0)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + einsum(
            "bhst,bthd->bhsd", p.to(vc.dtype), vc).float()
        return m_new, l_new, acc_new

    def full(shape, value, labels):
        return mesh_tensor(q, lambda s: torch.full(s, value, dtype=F32,
                                                   device=q.device),
                           shape, labels)
    m = full((b, h, sq), NEG_INF, lbl[:3])
    l = full((b, h, sq), 0.0, lbl[:3])
    acc = full((b, h, sq, dhv), 0.0, lbl)
    # with grad on, each chunk is rematerialized, as the reference's
    # jax.checkpoint(body): the backward recomputes the chunk's logits
    # instead of keeping a (Sq, kv_chunk) score block per chunk
    remat = torch.is_grad_enabled()
    for c0 in range(0, t, kv_chunk):
        args = (qs, q_pos, m, l, acc, k[:, c0:c0 + kv_chunk],
                v[:, c0:c0 + kv_chunk], c0)
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
    # (the heads are split into (KV, G) whole: DTensor has no view rule
    # splitting a sharded dim into factors its axis does not divide)
    qg = whole(q, 2).reshape(b, n_kv, h // n_kv, dh).float() * float(scale)
    logits = einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    pos = _arange(q, t)
    logits = torch.where((pos < length)[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


class _EmbedLookup(torch.autograd.Function):
    """Row gather whose backward adds the cotangent into zeros of the
    embedding's shape and dtype, as the reference's ``_embed_bwd``: no f32
    (vocab, d) buffer. Duplicate ids sum in that dtype, in index order on
    the CPU and by atomics in no fixed order on the card.

    DTensors (:func:`_sharded_lookup`): a vocab-parallel gather on the
    local shards, whose gradient is pinned to (vocab: model, d: dp)."""

    @staticmethod
    def forward(ctx, embed: torch.Tensor, tokens: torch.Tensor):
        ctx.embed_shape, ctx.embed_dtype = embed.shape, embed.dtype
        if isinstance(embed, DTensor):
            out, ctx.sharded = _sharded_lookup(embed, tokens)
            ctx.save_for_backward(*ctx.sharded.pop("saved"))
            return out
        ctx.sharded = None
        ctx.save_for_backward(tokens)
        return embed[tokens]

    @staticmethod
    def backward(ctx, dh: torch.Tensor):
        if ctx.sharded is not None:
            return _sharded_lookup_grad(ctx, dh), None
        (tokens,) = ctx.saved_tensors
        demb = torch.zeros(ctx.embed_shape, dtype=ctx.embed_dtype,
                           device=dh.device)
        demb.index_add_(0, tokens.reshape(-1),
                        dh.reshape(-1, dh.shape[-1]).to(ctx.embed_dtype))
        return demb, None


def _sharded_lookup(embed: DTensor, tokens: DTensor):
    """``embed[tokens]`` of DTensors on their local shards (DTensor's own
    rule for this gather refuses rows sharded over two mesh axes, and
    would gather the table): the table keeps its vocab shards and gathers
    its feature dim; the tokens keep their row shards; each rank picks the
    rows of its vocab range (zeros elsewhere), summed over the axes that
    shard the vocab."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = embed.device_mesh
    tok = whole(tokens, *range(1, tokens.ndim))
    tp = tok.placements
    ep = [Replicate() if isinstance(t, Shard) or isinstance(e, Shard)
          and e.dim != 0 else e for t, e in zip(tp, embed.placements)]
    emb = embed.redistribute(mesh, ep)
    _, offset = compute_local_shape_and_global_offset(emb.shape, mesh, ep)
    loc = emb.to_local()
    rel = tok.to_local().long() - offset[0]
    inside = (rel >= 0) & (rel < loc.shape[0])
    rel = rel.clamp(0, loc.shape[0] - 1)
    out = torch.where(inside[..., None], loc[rel], 0).to(loc.dtype)
    # the vocab shards' rows summed (one nonzero term: exact)
    out = all_reduce(out, mesh, [a for a, e in enumerate(ep)
                                 if isinstance(e, Shard)])
    plc = [t if isinstance(t, Shard) else Replicate() for t in tp]
    meta = {"saved": (rel, inside), "mesh": mesh, "tok": tp, "emb": ep}
    return DTensor.from_local(out, mesh, plc, run_check=False), meta


def _sharded_lookup_grad(ctx, dh: DTensor) -> DTensor:
    """The gradient of :func:`_sharded_lookup`: each rank adds its rows'
    cotangent into its vocab range; a partial sum over the row axes,
    reduce-scattered to (vocab: model, d: dp)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rel, inside = ctx.saved_tensors
    meta = ctx.sharded
    mesh, tp, ep = meta["mesh"], meta["tok"], meta["emb"]
    rows = [t if isinstance(t, Shard) else Replicate() for t in tp]
    g = dh.redistribute(mesh, rows).to_local()
    n = ctx.embed_shape[0] // int(np.prod([mesh.size(i) for i, e in
                                           enumerate(ep) if isinstance(e,
                                                                       Shard)]))
    z = torch.zeros((n, ctx.embed_shape[1]), dtype=ctx.embed_dtype,
                    device=g.device)
    z.index_add_(0, rel.reshape(-1),
                 (g * inside[..., None]).reshape(-1, g.shape[-1]).to(
                     ctx.embed_dtype))
    plc = [e if isinstance(e, Shard) else Partial() if isinstance(t, Shard)
           else Replicate() for t, e in zip(tp, ep)]
    demb = DTensor.from_local(z, mesh, plc, run_check=False)
    return shard_act(demb, "model", "dp")


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding row gather with the reference's custom backward: the
    cotangent is scatter-added in the embedding dtype (bf16)."""
    return _EmbedLookup.apply(embed, tokens)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP. On a mesh it is tensor-parallel over ``model``, the
    reference's plan: the sequence shard of a (B, S, d) input is gathered
    once, here, so the hidden dim of ``w_gate``/``w_up`` stays sharded as
    the weights are (``dist.sharding.einsum`` keeps the one subscript held
    over ``model``) and ``w_down`` sums its shards; no weight is gathered
    over ``model``."""
    if x.ndim == 3:
        x = shard_act(x, "dp", None, None)
    g = einsum("...d,df->...f", x, w_gate)
    u = einsum("...d,df->...f", x, w_up)
    act = F.silu(g) * u
    if act.ndim == 3:
        act = shard_act(act, "dp", None, "model")
    return einsum("...f,fd->...d", act, w_down).to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, vocab_valid: int) -> torch.Tensor:
    """Mean NLL over masked targets; padded vocab columns are excluded.
    DTensors go through :func:`_sharded_cross_entropy`."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, targets, mask, vocab_valid)
    logits = logits.float()
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < vocab_valid, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    lab = logits.gather(-1, targets[..., None].long())[..., 0]
    ll = lab - lse
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _sharded_cross_entropy(logits: DTensor, targets: DTensor, mask: DTensor,
                           vocab_valid: int) -> DTensor:
    """The loss of vocab-sharded logits on the local shards, as the
    reference's gather-free form: no rank gathers the (B, S, vocab)
    logits. The rows keep the targets' shards, the vocab its own; the
    softmax's max, normalizer and target logit are reduced over the vocab
    axes, the masked sum over the row axes (``dist.sharding.all_reduce``).
    The target logit is picked by a masked sum (one nonzero term: exact).
    With no vocab axis the local ops are the plain path's."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = logits.device_mesh
    v = logits.ndim - 1
    tp = whole(targets, *range(1, targets.ndim)).placements
    rows = [p if isinstance(p, Shard) else Replicate() for p in tp]
    plc = [r if isinstance(r, Shard) else
           Shard(v) if isinstance(p, Shard) and p.dim == v else Replicate()
           for r, p in zip(rows, logits.placements)]
    x = logits.redistribute(mesh, plc)
    _, offset = compute_local_shape_and_global_offset(x.shape, mesh, plc)
    x = x.to_local().float()
    tgt = targets.redistribute(mesh, rows).to_local()
    msk = mask.redistribute(mesh, rows).to_local()
    vocab_axes = [a for a, p in enumerate(plc) if p == Shard(v)]
    row_axes = [a for a, p in enumerate(rows) if isinstance(p, Shard)]
    col = offset[v] + torch.arange(x.shape[-1], device=x.device)
    x = torch.where(col < vocab_valid, x, NEG_INF)
    if vocab_axes:
        m = all_reduce(x.detach().amax(-1), mesh, vocab_axes, "max")
        se = all_reduce(torch.exp(x - m[..., None]).sum(-1), mesh, vocab_axes)
        lse = m + torch.log(se)
    else:
        lse = torch.logsumexp(x, dim=-1)
    lab = all_reduce(torch.where(col == tgt[..., None], x, 0.0).sum(-1),
                     mesh, vocab_axes)
    ll = lab - lse
    num = all_reduce((ll * msk).sum(), mesh, row_axes)
    den = all_reduce(msk.sum(), mesh, row_axes)
    loss = -num / torch.clamp(den, min=1.0)
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
