"""Per-family transformer blocks: param specs + apply fns (prefill & decode).

Each block family provides, as in the reference (``repro.models.blocks``):
  <family>_spec(cfg)                      -> PSpec tree (one layer)
  <family>_apply(p, h, ctx)               -> h'      (full sequence)
  <family>_decode(p, h, cache, ctx)       -> h', cache'
  <family>_cache_spec(cfg, B, S)          -> PSpec tree of the per-layer cache

Caches are stored in bf16; MLA caches stay compressed (rank + rope dims).
The decode functions write the new position into the cache tensors they are
given, in place, and return those same tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (attention, decode_attention, einsum,
                                       rms_norm, rope, swiglu, BF16, F32)
from repro_torch.models.spec import PSpec


class Ctx(NamedTuple):
    """Non-param inputs threaded through blocks."""
    positions: Optional[torch.Tensor]   # (B, S) absolute positions
    length: Union[int, torch.Tensor]    # valid cache length (decode)
    memory: Optional[torch.Tensor] = None  # encoder output / image embeddings


def _attn_chunk(cfg: ArchConfig, seq: int) -> int:
    return cfg.attn_chunk if seq > 2 * cfg.attn_chunk else 0


# =============================================================== dense GQA attn
def attn_spec(cfg: ArchConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    spec = {
        "ln": PSpec((d,), ("embed",), init="ones"),
        "wq": PSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = PSpec((h, dh), ("heads", "head_dim"), init="zeros")
        spec["bk"] = PSpec((kv, dh), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = PSpec((kv, dh), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    q = einsum("bsd,dhq->bshq", x, p["wq"])
    k = einsum("bsd,dhq->bshq", x, p["wk"])
    v = einsum("bsd,dhq->bshq", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(h: torch.Tensor, o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return h + einsum("bshq,hqd->bsd", o, wo).to(h.dtype)


def _self_attn(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
               causal: bool):
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, ctx.positions, cfg.rope_theta)
    k = rope(k, ctx.positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, kv_chunk=_attn_chunk(cfg, h.shape[1]))
    return _out_proj(h, o, p["wo"]), k, v


def attn_apply(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
               *, causal: bool = True) -> torch.Tensor:
    return _self_attn(p, h, ctx, cfg, causal)[0]


def attn_cache_spec(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    kv, dh = cfg.n_kv_heads, cfg.dh
    sh = (batch, max_seq, kv, dh)
    lg = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": PSpec(sh, lg, init="zeros"), "v": PSpec(sh, lg, init="zeros")}


def _pad_seq(x: torch.Tensor, max_seq: int) -> torch.Tensor:
    """Zero-pad dim 1 to ``max_seq`` and cast to the cache dtype (bf16)."""
    out = x.new_zeros((x.shape[0], max_seq, *x.shape[2:]), dtype=BF16)
    out[:, :x.shape[1]] = x
    return out


def attn_prefill_cache(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
                       max_seq: int):
    """Full-seq forward that also returns the populated KV cache."""
    out, k, v = _self_attn(p, h, ctx, cfg, True)
    return out, {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq)}


def _decode_positions(h: torch.Tensor, length) -> torch.Tensor:
    return torch.full(h.shape[:2], int(length), dtype=torch.int32,
                      device=h.device)


def attn_decode(p: dict, h: torch.Tensor, cache: dict, ctx: Ctx,
                cfg: ArchConfig):
    """One position against the cache; writes it at ``ctx.length`` in place."""
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, x, cfg)
    pos = _decode_positions(h, ctx.length)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    n = int(ctx.length)
    cache["k"][:, n:n + 1] = k
    cache["v"][:, n:n + 1] = v
    o = decode_attention(q, cache["k"], cache["v"], n + 1)
    return _out_proj(h, o, p["wo"]), cache


# ============================================================ cross attention
def cross_attn_spec(cfg: ArchConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {
        "ln": PSpec((d,), ("embed",), init="ones"),
        "wq": PSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": PSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": PSpec((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": PSpec((h, dh, d), ("heads", "head_dim", "embed")),
        "gate": PSpec((1,), (None,), init="zeros"),
    }


def gate(p: dict, h: torch.Tensor):
    return torch.tanh(p["gate"].float()).to(h.dtype) if "gate" in p else 1.0


def cross_attn_kv(p: dict, h: torch.Tensor, mem: torch.Tensor,
                  cfg: ArchConfig):
    """Cross-attention of ``h`` over ``mem``; returns (h', k, v)."""
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    q = einsum("bsd,dhq->bshq", x, p["wq"])
    k = einsum("bsd,dhq->bshq", mem, p["wk"])
    v = einsum("bsd,dhq->bshq", mem, p["wv"])
    o = attention(q, k, v, causal=False)
    out = h + gate(p, h) * einsum("bshq,hqd->bsd", o, p["wo"]).to(h.dtype)
    return out, k, v


def cross_attn_apply(p: dict, h: torch.Tensor, ctx: Ctx,
                     cfg: ArchConfig) -> torch.Tensor:
    return cross_attn_kv(p, h, ctx.memory, cfg)[0]


# ==================================================================== MLA attn
def mla_spec(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qdim = m.nope_head_dim + m.rope_head_dim
    spec = {
        "ln": PSpec((d,), ("embed",), init="ones"),
        "w_dkv": PSpec((d, m.kv_lora_rank + m.rope_head_dim), ("embed", "kv_lora")),
        "kv_ln": PSpec((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": PSpec((m.kv_lora_rank, H, m.nope_head_dim),
                      ("kv_lora", "heads", "head_dim")),
        "w_uv": PSpec((m.kv_lora_rank, H, m.v_head_dim),
                      ("kv_lora", "heads", "head_dim")),
        "wo": PSpec((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }
    if m.q_lora_rank:
        spec["w_dq"] = PSpec((d, m.q_lora_rank), ("embed", "q_lora"))
        spec["q_ln"] = PSpec((m.q_lora_rank,), (None,), init="ones")
        spec["w_uq"] = PSpec((m.q_lora_rank, H, qdim), ("q_lora", "heads", "head_dim"))
    else:
        spec["w_q"] = PSpec((d, H, qdim), ("embed", "heads", "head_dim"))
    return spec


def _mla_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions):
    m = cfg.mla
    if "w_dq" in p:
        cq = rms_norm(einsum("bsd,dr->bsr", x, p["w_dq"]), p["q_ln"],
                      cfg.norm_eps)
        q = einsum("bsr,rhq->bshq", cq, p["w_uq"])
    else:
        q = einsum("bsd,dhq->bshq", x, p["w_q"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv_full = einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_kv = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = rope(ckv_full[..., None, m.kv_lora_rank:], positions,
                  cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0]


def _mla_scale(cfg: ArchConfig) -> float:
    m = cfg.mla
    return 1.0 / np.sqrt(m.nope_head_dim + m.rope_head_dim)


def _mla_forward(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig):
    """Full-sequence MLA (decompressed K/V); returns (h', c_kv, k_rope)."""
    m = cfg.mla
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, ctx.positions)
    k_nope = einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    v = einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        *k_rope.shape[:2], cfg.n_heads, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(q, k, v, causal=True, kv_chunk=_attn_chunk(cfg, h.shape[1]),
                  softmax_scale=_mla_scale(cfg))
    return _out_proj(h, o, p["wo"]), c_kv, k_rope


def mla_apply(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig) -> torch.Tensor:
    return _mla_forward(p, h, ctx, cfg)[0]


def mla_cache_spec(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    m = cfg.mla
    return {
        "c_kv": PSpec((batch, max_seq, m.kv_lora_rank),
                      ("batch", "cache_seq", None), init="zeros"),
        "k_rope": PSpec((batch, max_seq, m.rope_head_dim),
                        ("batch", "cache_seq", None), init="zeros"),
    }


def mla_prefill_cache(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
                      max_seq: int):
    out, c_kv, k_rope = _mla_forward(p, h, ctx, cfg)
    return out, {"c_kv": _pad_seq(c_kv, max_seq),
                 "k_rope": _pad_seq(k_rope, max_seq)}


def mla_decode(p: dict, h: torch.Tensor, cache: dict, ctx: Ctx,
               cfg: ArchConfig):
    """Absorbed MLA decode: attention in the compressed rank-r space; writes
    the new position into the cache in place."""
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    pos = _decode_positions(h, ctx.length)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, pos)
    n = int(ctx.length)
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    c_cache[:, n:n + 1] = c_kv_new
    r_cache[:, n:n + 1] = k_rope_new
    # absorb W_uk into q: q_eff (B,S,H,r)
    q_eff = einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    logits = (einsum("bshr,btr->bhst", q_eff.float(), c_cache.float())
              + einsum("bshk,btk->bhst", q_rope.float(), r_cache.float())
              ) * float(_mla_scale(cfg))
    t = c_cache.shape[1]
    posi = torch.arange(t, device=h.device)
    logits = torch.where((posi < n + 1)[None, None, None], logits, -1e30)
    pattn = torch.softmax(logits, dim=-1)
    o_c = einsum("bhst,btr->bshr", pattn.to(c_cache.dtype), c_cache)
    o = einsum("bshr,rhk->bshk", o_c, p["w_uv"])
    return _out_proj(h, o, p["wo"]), cache


# ===================================================================== MLPs
def mlp_spec(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    return {
        "ln": PSpec((d,), ("embed",), init="ones"),
        "w_gate": PSpec((d, f), ("embed", "mlp")),
        "w_up": PSpec((d, f), ("embed", "mlp")),
        "w_down": PSpec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    return h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


def moe_spec(cfg: ArchConfig) -> dict:
    mo = cfg.moe
    d, E, fe = cfg.d_model, mo.num_experts, mo.d_expert
    spec = {
        "ln": PSpec((d,), ("embed",), init="ones"),
        "router": PSpec((d, E), ("embed", None), dtype=F32),
        "we_gate": PSpec((E, d, fe), ("experts", None, "moe_mlp")),
        "we_up": PSpec((E, d, fe), ("experts", None, "moe_mlp")),
        "we_down": PSpec((E, fe, d), ("experts", "moe_mlp", None)),
    }
    if mo.num_shared:
        fs = mo.d_expert * mo.num_shared
        spec["ws_gate"] = PSpec((d, fs), ("embed", "mlp"))
        spec["ws_up"] = PSpec((d, fs), ("embed", "mlp"))
        spec["ws_down"] = PSpec((fs, d), ("mlp", "embed"))
    return spec


def moe_capacity(cfg: ArchConfig, s: int) -> int:
    """Slots per expert and group, exactly as the reference computes them."""
    mo = cfg.moe
    k = mo.top_k
    cap = int(np.ceil(s * k * mo.capacity_factor / mo.num_experts / 4.0)) * 4
    return max(cap, min(k, s * k))


# ------------------------------------------------ gather-mirrored MoE VJPs
# Dispatch and combine are index bijections (plus drops), so each backward
# is itself a gather, as in the reference's custom VJPs
# (repro/models/blocks.py:262-336): the MoE data path does no scatter in
# either direction, which on the card also makes its backward deterministic.

def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (G, n, d) gathered along dim 1 by idx (G, m) -> (G, m, d)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class _DispatchGather(torch.autograd.Function):
    """(G,s+1,d) token rows -> (G,E,C,d) expert slots (slot_tok sentinel s,
    the zero row). Backward: the slots' cotangent gathered back per sorted
    assignment through (e_c, pos_c) (dropped ones read the zero slot),
    unsorted by the inverse permutation and summed over the k assignments
    of each token."""

    @staticmethod
    def forward(ctx, xpad, slot_tok, e_c, pos_c, inv_order):
        ctx.save_for_backward(e_c, pos_c, inv_order)
        ctx.s = xpad.shape[1] - 1
        gidx = torch.arange(xpad.shape[0], device=xpad.device)[:, None, None]
        return xpad[gidx, slot_tok]

    @staticmethod
    def backward(ctx, d_ebuf):
        e_c, pos_c, inv_order = ctx.saved_tensors
        G, E, C, dd = d_ebuf.shape
        s = ctx.s
        k = e_c.shape[1] // s
        dpad = F.pad(d_ebuf, (0, 0, 0, 1, 0, 1))             # (G,E+1,C+1,d)
        gidx = torch.arange(G, device=d_ebuf.device)[:, None]
        d_rows = dpad[gidx, e_c, pos_c]                       # (G,sk,d)
        d_x = _rows(d_rows, inv_order).reshape(G, s, k, dd).sum(dim=2)
        return F.pad(d_x, (0, 0, 0, 1)), None, None, None, None


class _CombineGather(torch.autograd.Function):
    """(G,E+1,C+1,d) expert outputs -> (G,sk,d) per sorted assignment.
    Backward: the assignments' cotangent gathered into the slots through
    slot_asn (empty slots read row sk, a zero row)."""

    @staticmethod
    def forward(ctx, ypad, e_c, pos_c, slot_asn):
        ctx.save_for_backward(slot_asn)
        gidx = torch.arange(ypad.shape[0], device=ypad.device)[:, None]
        return ypad[gidx, e_c, pos_c]

    @staticmethod
    def backward(ctx, d_rows):
        (slot_asn,) = ctx.saved_tensors
        G, sk, dd = d_rows.shape
        dpad = F.pad(d_rows, (0, 0, 0, 1))                    # row sk = zeros
        gidx = torch.arange(G, device=d_rows.device)[:, None, None]
        return dpad[gidx, slot_asn], None, None, None


class _Permute(torch.autograd.Function):
    """Rows of (G,n,d) reordered by a permutation idx; backward gathers
    through the inverse permutation."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return _rows(x, idx)

    @staticmethod
    def backward(ctx, d):
        (inv_idx,) = ctx.saved_tensors
        return _rows(d, inv_idx), None, None


class DispatchPlan(NamedTuple):
    """The index maps of one group-wise dispatch (G groups of s tokens, k
    assignments each, E experts of ``cap`` slots)."""
    order: torch.Tensor      # (G,sk) assignments sorted by expert (stable)
    inv_order: torch.Tensor  # (G,sk) its inverse permutation
    e_c: torch.Tensor        # (G,sk) expert of each sorted assignment; E if dropped
    pos_c: torch.Tensor      # (G,sk) its slot; cap if dropped
    keep: torch.Tensor       # (G,sk) bool, not dropped
    slot_tok: torch.Tensor   # (G,E+1,cap+1) token of each slot; s if empty
    slot_asn: torch.Tensor   # (G,E+1,cap+1) sorted assignment of each slot; sk if empty


def dispatch_plan(eg: torch.Tensor, num_experts: int, cap: int) -> DispatchPlan:
    """Plan the dispatch of expert choices ``eg`` (G,s,k): each group
    stable-sorts its s·k assignments by expert and keeps the first ``cap``
    of each expert (the capacity drop). The only scatters here build the
    int slot maps; the dropped assignments all land in slot (E, cap)."""
    G, s, k = eg.shape
    E, sk, dev = num_experts, s * k, eg.device
    e_flat = eg.reshape(G, sk)
    tok_flat = torch.arange(s, dtype=torch.int64, device=dev).repeat_interleave(
        k)[None].expand(G, sk)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)
    e_srt = torch.gather(e_flat, -1, order)
    t_srt = torch.gather(tok_flat, -1, order)
    # position within expert, per group
    counts = F.one_hot(e_flat, E).sum(dim=1)                      # (G,E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(sk, device=dev)[None]
           - torch.gather(starts, -1, e_srt))
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap)
    e_c = torch.where(keep, e_srt, E)
    gidx = torch.arange(G, device=dev)[:, None]
    slot_tok = torch.full((G, E + 1, cap + 1), s, dtype=torch.int64, device=dev)
    slot_tok[gidx, e_c, pos_c] = t_srt
    slot_asn = torch.full((G, E + 1, cap + 1), sk, dtype=torch.int64,
                          device=dev)
    slot_asn[gidx, e_c, pos_c] = torch.arange(sk, device=dev)[None].expand(G, sk)
    return DispatchPlan(order, inv_order, e_c, pos_c, keep, slot_tok, slot_asn)


def _group_dispatch(p: dict, xg: torch.Tensor, eg: torch.Tensor,
                    gg: torch.Tensor, cap: int) -> torch.Tensor:
    """xg (G,s,d), eg (G,s,k), gg (G,s,k) -> MoE output (G,s,d).

    Gathers the kept token rows into a (G,E,C,d) buffer, runs the experts
    and gathers the outputs back (``dispatch_plan``). Token rows move only
    by gathers, forward and backward.
    """
    G, s, d = xg.shape
    k = eg.shape[-1]
    E = p["we_gate"].shape[0]
    plan = dispatch_plan(eg, E, cap)
    xpad = F.pad(xg, (0, 0, 0, 1))                                # row s = zeros
    ebuf = _DispatchGather.apply(xpad, plan.slot_tok[:, :E, :cap], plan.e_c,
                                 plan.pos_c, plan.inv_order)      # (G,E,C,d)
    ebuf = ebuf.transpose(0, 1).reshape(E, G * cap, d)
    gg_ = torch.bmm(ebuf, p["we_gate"])
    uu = torch.bmm(ebuf, p["we_up"])
    yy = torch.bmm(F.silu(gg_) * uu, p["we_down"])                # (E,G·C,d)
    yb = yy.reshape(E, G, cap, d).transpose(0, 1)
    ypad = F.pad(yb, (0, 0, 0, 1, 0, 1))                          # (G,E+1,C+1,d)
    y_srt = _CombineGather.apply(ypad, plan.e_c, plan.pos_c,
                                 plan.slot_asn)                   # (G,sk,d)
    g_srt = torch.gather(gg.reshape(G, s * k), -1, plan.order)
    y_srt = y_srt * (g_srt * plan.keep)[..., None].to(yy.dtype)
    y_unsrt = _Permute.apply(y_srt, plan.inv_order, plan.order)
    return y_unsrt.reshape(G, s, k, d).sum(dim=2)


def moe_apply(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Group-wise sort-based dropping dispatch, one group per batch row.

    Groups are processed in ``dispatch_chunks`` sequential chunks of batch
    rows, which bounds the dispatch buffers; a group's result does not
    depend on the chunking.
    """
    mo = cfg.moe
    b, s, d = h.shape
    k = mo.top_k
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    cap = moe_capacity(cfg, s)

    logits = einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1, sorted=True)      # (b,s,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    nchunk = max(1, min(mo.dispatch_chunks, b))
    while b % nchunk:
        nchunk -= 1
    step = b // nchunk
    # with grad on and more than one chunk, each chunk is rematerialized, as
    # the reference's lax.map(jax.checkpoint(...)): its dispatch buffers are
    # recomputed in the backward instead of kept for every chunk
    remat = nchunk > 1 and torch.is_grad_enabled()
    outs = []
    for i in range(0, b, step):
        args = (p, x[i:i + step], eidx[i:i + step], gates[i:i + step], cap)
        outs.append(checkpoint(_group_dispatch, *args, use_reentrant=False)
                    if remat else _group_dispatch(*args))
    out = torch.cat(outs)
    if mo.num_shared:
        out = out + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return h + out.to(h.dtype)
