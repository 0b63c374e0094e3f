"""Per-family transformer blocks: param specs + apply fns (prefill & decode).

Each block family provides, as in the reference (``repro.models.blocks``):
  <family>_spec(cfg)                      -> PSpec tree (one layer)
  <family>_apply(p, h, ctx)               -> h'      (full sequence)
  <family>_decode(p, h, cache, ctx)       -> h', cache'
  <family>_cache_spec(cfg, B, S)          -> PSpec tree of the per-layer cache

Caches are stored in bf16; MLA caches stay compressed (rank + rope dims).
The decode functions write the new position into the cache tensors they are
given, in place, and return those same tensors (on a mesh, into the local
shard that holds the position). The reference's sharding constraints are
kept at its sites (``dist.sharding``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (concat_rows, current_mesh, dp_axis_size,
                                       mesh_tensor, placements, shard_act,
                                       shard_res)
from repro_torch.dist.sharding import along, pad as pad_
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
    q = shard_act(q, "dp", None, "model", None)
    k = shard_act(k, "dp", None, "model", None)
    v = shard_act(v, "dp", None, "model", None)
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
    o = shard_act(o, "dp", None, "model", None)
    return shard_res(_out_proj(h, o, p["wo"])), k, v


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
    pad = [0, 0] * (x.ndim - 2) + [0, max_seq - x.shape[1]]
    return pad_(x, pad).to(BF16)


def attn_prefill_cache(p: dict, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
                       max_seq: int):
    """Full-seq forward that also returns the populated KV cache."""
    out, k, v = _self_attn(p, h, ctx, cfg, True)
    return out, {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq)}


def _decode_positions(h: torch.Tensor, length) -> torch.Tensor:
    return mesh_tensor(h, lambda s: torch.full(s, int(length),
                                               dtype=torch.int32,
                                               device=h.device), h.shape[:2])


def _write_at(cache: torch.Tensor, n: int, new: torch.Tensor) -> None:
    """``cache[:, n:n+1] = new`` in place. A DTensor cache whose position
    axis is sharded is written in its local shard: only the rank holding
    position ``n`` writes, so nothing is gathered."""
    if not isinstance(cache, DTensor):
        cache[:, n:n + 1] = new
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    # the new row: the cache's layout with the (length-1) position axis whole
    plc = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
           for p in cache.placements]
    row = new.to(cache.dtype).redistribute(mesh, plc).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    start = n - offset[1]
    if 0 <= start < shape[1]:
        cache.to_local()[:, start:start + 1] = row


def attn_decode(p: dict, h: torch.Tensor, cache: dict, ctx: Ctx,
                cfg: ArchConfig):
    """One position against the cache; writes it at ``ctx.length`` in place."""
    x = rms_norm(h, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, x, cfg)
    pos = _decode_positions(h, ctx.length)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    n = int(ctx.length)
    _write_at(cache["k"], n, k)
    _write_at(cache["v"], n, v)
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
    k_nope = shard_act(einsum("bsr,rhk->bshk", c_kv, p["w_uk"]),
                       "dp", None, "model", None)
    v = shard_act(einsum("bsr,rhk->bshk", c_kv, p["w_uv"]),
                  "dp", None, "model", None)
    labels = ("dp", None, "model", None)
    k = concat_rows([k_nope, k_rope[:, :, None].expand(
        *k_rope.shape[:2], cfg.n_heads, m.rope_head_dim)], axis=-1,
        labels=labels)
    q = shard_act(concat_rows([q_nope, q_rope], axis=-1, labels=labels),
                  *labels)
    o = attention(q, k, v, causal=True, kv_chunk=_attn_chunk(cfg, h.shape[1]),
                  softmax_scale=_mla_scale(cfg))
    o = shard_act(o, *labels)
    return shard_res(_out_proj(h, o, p["wo"])), c_kv, k_rope


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
    _write_at(c_cache, n, c_kv_new)
    _write_at(r_cache, n, k_rope_new)
    # absorb W_uk into q: q_eff (B,S,H,r)
    q_eff = einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    logits = (einsum("bshr,btr->bhst", q_eff.float(), c_cache.float())
              + einsum("bshk,btk->bhst", q_rope.float(), r_cache.float())
              ) * float(_mla_scale(cfg))
    t = c_cache.shape[1]
    posi = mesh_tensor(h, lambda s: torch.arange(t, device=h.device), (t,))
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
    return shard_res(h + swiglu(x, p["w_gate"], p["w_up"], p["w_down"]))


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
# Every gather is batched over the group axis G (``torch.gather`` along dim
# 1), so on a mesh it stays local to each group's data shard.

def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (G, n, d) gathered along dim 1 by idx (G, m) -> (G, m, d)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _slots(x: torch.Tensor, e: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """x (G, E', C', d) read at slots (e, pos) (G, m) -> (G, m, d)."""
    G, E1, C1, dd = x.shape
    return _rows(x.reshape(G, E1 * C1, dd), e * C1 + pos)


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
        G, E, C = slot_tok.shape
        return _rows(xpad, slot_tok.reshape(G, E * C)).reshape(
            G, E, C, xpad.shape[-1])

    @staticmethod
    def backward(ctx, d_ebuf):
        e_c, pos_c, inv_order = ctx.saved_tensors
        G, E, C, dd = d_ebuf.shape
        s = ctx.s
        k = e_c.shape[1] // s
        dpad = pad_(d_ebuf, (0, 0, 0, 1, 0, 1))             # (G,E+1,C+1,d)
        d_rows = shard_act(_slots(dpad, e_c, pos_c), "dp", None, None)
        d_x = _rows(d_rows, inv_order).reshape(G, s, k, dd).sum(dim=2)
        return pad_(d_x, (0, 0, 0, 1)), None, None, None, None


class _CombineGather(torch.autograd.Function):
    """(G,E+1,C+1,d) expert outputs -> (G,sk,d) per sorted assignment.
    Backward: the assignments' cotangent gathered into the slots through
    slot_asn (empty slots read row sk, a zero row)."""

    @staticmethod
    def forward(ctx, ypad, e_c, pos_c, slot_asn):
        ctx.save_for_backward(slot_asn)
        return _slots(ypad, e_c, pos_c)

    @staticmethod
    def backward(ctx, d_rows):
        (slot_asn,) = ctx.saved_tensors
        G, sk, dd = d_rows.shape
        dpad = pad_(d_rows, (0, 0, 0, 1))                    # row sk = zeros
        _, E1, C1 = slot_asn.shape
        d_ypad = _rows(dpad, slot_asn.reshape(G, E1 * C1)).reshape(
            G, E1, C1, dd)
        return shard_act(d_ypad, "dp", None, None, None), None, None, None


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

    def made(make, shape, labels=None):
        return mesh_tensor(eg, make, shape, labels)
    e_flat = eg.reshape(G, sk)
    tok_flat = made(lambda sh: torch.arange(
        s, dtype=torch.int64, device=dev).repeat_interleave(k), (sk,))
    tok_flat = tok_flat[None].expand(G, sk)
    asn = made(lambda sh: torch.arange(sk, device=dev), (sk,))[None]
    order = torch.argsort(e_flat, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)
    e_srt = torch.gather(e_flat, -1, order)
    t_srt = torch.gather(tok_flat, -1, order)
    # position within expert, per group
    counts = F.one_hot(e_flat, E).sum(dim=1)                      # (G,E)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = asn - torch.gather(starts, -1, e_srt)
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap)
    e_c = torch.where(keep, e_srt, E)
    slot = e_c * (cap + 1) + pos_c                                # (G,sk)

    def slot_map(fill, src):
        base = made(lambda sh: torch.full(sh, fill, dtype=torch.int64,
                                          device=dev),
                    (G, (E + 1) * (cap + 1)), ("dp", None))
        return torch.scatter(base, 1, slot, src).reshape(G, E + 1, cap + 1)
    slot_tok = slot_map(s, t_srt)
    slot_asn = slot_map(sk, asn.expand(G, sk))
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
    xpad = pad_(xg, (0, 0, 0, 1))                                # row s = zeros
    ebuf = shard_act(_DispatchGather.apply(
        xpad, plan.slot_tok[:, :E, :cap], plan.e_c, plan.pos_c,
        plan.inv_order), "dp", None, None, None)                  # (G,E,C,d)
    # the expert-parallel exchange: slice E per model rank, then a
    # layout-preserving transpose to (E: model, G: dp)
    ebuf = shard_act(ebuf, "dp", "model", None, None)
    ebuf = shard_act(ebuf.transpose(0, 1), "model", "dp", None, None)
    gg_ = einsum("egcd,edf->egcf", ebuf, p["we_gate"])
    uu = einsum("egcd,edf->egcf", ebuf, p["we_up"])
    yy = einsum("egcf,efd->egcd", F.silu(gg_) * uu, p["we_down"])  # (E,G,C,d)
    yb = shard_act(yy.transpose(0, 1), "dp", None, None, None)
    ypad = pad_(yb, (0, 0, 0, 1, 0, 1))                          # (G,E+1,C+1,d)
    y_srt = shard_act(_CombineGather.apply(ypad, plan.e_c, plan.pos_c,
                                           plan.slot_asn),
                      "dp", None, None)                           # (G,sk,d)
    g_srt = torch.gather(gg.reshape(G, s * k), -1, plan.order)
    y_srt = y_srt * (g_srt * plan.keep)[..., None].to(yy.dtype)
    y_unsrt = shard_act(_Permute.apply(y_srt, plan.inv_order, plan.order),
                        "dp", None, None)
    return y_unsrt.reshape(G, s, k, d).sum(dim=2)


def _row_layout(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its rows over dp (when they divide) and every other
    dim whole; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    labels = ("dp",) + (None,) * (t.ndim - 1)
    return t.redistribute(t.device_mesh,
                          placements(t.device_mesh, t.shape, labels))


def _chunk_rows(t: torch.Tensor, n: int) -> list:
    """``t``'s rows (in the row layout) in ``n`` chunks: chunk i is the
    i-th contiguous n-th of every dp shard's rows, so splitting moves no
    data. Off-mesh (one shard) chunk i is rows [i·b/n, (i+1)·b/n), as in
    the reference; on a mesh the groups are assigned to chunks in another
    order, which changes nothing, as every group is dispatched alone."""
    if not isinstance(t, DTensor):
        return list(t.reshape(n, t.shape[0] // n, *t.shape[1:]).unbind(0))
    loc = t.to_local()
    return [DTensor.from_local(c, t.device_mesh, t.placements,
                               run_check=False)
            for c in loc.reshape(n, -1, *loc.shape[1:]).unbind(0)]


def _join_rows(chunks: list) -> torch.Tensor:
    """The inverse of :func:`_chunk_rows`."""
    first = chunks[0]
    if not isinstance(first, DTensor):
        # lint: ok(R001) the off-mesh branch: the chunks are plain tensors here
        return torch.stack(chunks).reshape(-1, *first.shape[1:])
    # lint: ok(R001) stacks the chunks' local shards (plain tensors); the DTensor is rebuilt from them on the chunks' own placements
    loc = torch.stack([c.to_local() for c in chunks])
    loc = loc.reshape(-1, *loc.shape[2:])
    return DTensor.from_local(loc, first.device_mesh, first.placements,
                              run_check=False)


def moe_apply(p: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Group-wise sort-based dropping dispatch, one group per batch row.

    Groups are processed in sequential chunks of batch rows, which bounds
    the dispatch buffers; a group's result does not depend on the chunking.
    The chunk count is the reference's: at most ``dispatch_chunks``, and
    on a mesh no more than leaves one group per data shard in each chunk.
    """
    mo = cfg.moe
    b, s, d = h.shape
    k = mo.top_k
    # the sequence-parallel -> full-sequence boundary: one gather of S here
    x = shard_act(rms_norm(h, p["ln"], cfg.norm_eps), "dp", None, None)
    cap = moe_capacity(cfg, s)

    logits = einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    # (on the local rows: topk's backward does not run on DTensors in
    # every torch release)
    gates, eidx = along(probs, lambda t: torch.topk(t, k, dim=-1,
                                                    sorted=True), -1)  # (b,s,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    mesh = current_mesh()
    ndp = dp_axis_size(mesh) if mesh is not None else 1
    nchunk = max(1, min(mo.dispatch_chunks, b // max(ndp, 1)))
    x, eidx, gates = (_row_layout(t) for t in (x, eidx, gates))
    rows = x.to_local().shape[0] if isinstance(x, DTensor) else b
    while b % nchunk or rows % nchunk:
        nchunk -= 1
    if nchunk > 1:
        xr, er, gr = (_chunk_rows(t, nchunk) for t in (x, eidx, gates))
        # with grad on each chunk is rematerialized, as the reference's
        # lax.map(jax.checkpoint(...)): its dispatch buffers are recomputed
        # in the backward instead of kept for every chunk
        remat = torch.is_grad_enabled()
        outs = []
        for i in range(nchunk):
            args = (p, xr[i], er[i], gr[i], cap)
            outs.append(checkpoint(_group_dispatch, *args, use_reentrant=False)
                        if remat else _group_dispatch(*args))
        out = _join_rows([_row_layout(o) for o in outs])
    else:
        out = _group_dispatch(p, x, eidx, gates, cap)
    out = shard_act(out, "dp", None, None)
    if mo.num_shared:
        out = out + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    return shard_res(h + out.to(h.dtype))
