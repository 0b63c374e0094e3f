"""SSM blocks: Mamba2 (SSD, chunked matmul form) and RWKV6 (Finch).

The same computations as the reference (``repro.models.ssm``): Mamba2 as
the SSD block decomposition (intra-chunk "attention-like" products, then a
scan over chunk states), RWKV6 as a sequential wkv recurrence over time,
vectorized over batch and heads. The reference's ``lax.scan`` loops are
Python loops here. Its sharding constraints are kept at its sites
(``dist.sharding``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import (concat_rows, mesh_tensor, shard_act,
                                       shard_res, whole)
from repro_torch.dist.sharding import along, pad as pad_
from repro_torch.models.layers import einsum, rms_norm, BF16, F32
from repro_torch.models.spec import PSpec


# ==================================================================== Mamba2
def mamba2_spec(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "ln": PSpec((d,), ("embed",), init="ones"),
        # order: [z (gate), x, B, C, dt]
        "w_in": PSpec((d, 2 * d_in + 2 * s.n_groups * s.d_state + n_heads),
                      ("embed", "mlp")),
        "conv_w": PSpec((s.d_conv, conv_dim), ("dconv", "mlp")),
        "conv_b": PSpec((conv_dim,), ("mlp",), init="zeros"),
        "a_log": PSpec((n_heads,), (None,), init="zeros", dtype=F32),
        "dt_bias": PSpec((n_heads,), (None,), init="zeros", dtype=F32),
        "d_skip": PSpec((n_heads,), (None,), init="ones", dtype=F32),
        "out_ln": PSpec((d_in,), ("mlp",), init="ones"),
        "w_out": PSpec((d_in, d), ("mlp", "embed")),
    }


def _mamba_proj(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """(z, [x|B|C] conv input, dt) from the input projection."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    zxbcdt = shard_act(einsum("bsd,de->bse", x, p["w_in"]),
                       "dp", None, "model")
    z = zxbcdt[..., :d_in]
    # [x|B|C] re-joined on the model-sharded feature axis (the reference's
    # concat of the three slices, which is this one slice)
    conv_in = shard_act(zxbcdt[..., d_in:2 * d_in + 2 * gn],
                        "dp", None, "model")
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    assert dt.shape[-1] == d_in // s.head_dim
    return z, conv_in, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d via shifted adds (kernel is tiny)."""
    k = w.shape[0]
    out = u * w[k - 1]
    for i in range(1, k):
        shifted = pad_(u, (0, 0, i, 0))[:, :u.shape[1]]
        out = out + shifted * w[k - 1 - i]
    return F.silu(out + b)


def mamba2_apply(p: dict, h: torch.Tensor, cfg: ArchConfig,
                 return_cache: bool = False):
    """Full-sequence SSD. h: (B, S, d). With ``return_cache`` also returns the
    post-sequence recurrent cache {conv, state} for decode continuation."""
    s = cfg.ssm
    B_, S, d = h.shape
    d_in = s.expand * d
    H = d_in // s.head_dim
    P, N, G = s.head_dim, s.d_state, s.n_groups
    cs = s.chunk

    x0 = rms_norm(h, p["ln"], cfg.norm_eps)
    z, conv_in, dt = _mamba_proj(p, x0, cfg)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])

    S_real = S
    pad = (-S) % cs
    if pad:
        # dt is forced to 0 at padded steps => identity state transitions
        conv_out = pad_(conv_out, (0, 0, 0, pad))
        dt = pad_(dt, (0, 0, 0, pad))
        S = S + pad
    xin = conv_out[..., :d_in]
    Bc = conv_out[..., d_in:d_in + G * N].reshape(B_, S, G, N)
    Cc = conv_out[..., d_in + G * N:].reshape(B_, S, G, N)

    a = -torch.exp(p["a_log"])                                    # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"])    # (B,S,H)
    if pad:
        t_idx = mesh_tensor(h, lambda sh: torch.arange(S, device=h.device),
                            (S,))
        dt = dt * (t_idx < S_real)[None, :, None]
    dA = dt * a                                                   # (B,S,H) <=0
    nc = S // cs

    xh = xin.reshape(B_, nc, cs, H, P)
    Bh = Bc.reshape(B_, nc, cs, G, N)
    Ch = Cc.reshape(B_, nc, cs, G, N)
    dtc = dt.reshape(B_, nc, cs, H)
    dAc = dA.reshape(B_, nc, cs, H)
    # (on the local shards: cumsum's backward flips, which DTensor has no
    # rule for in every torch release)
    cum = along(dAc, lambda t: torch.cumsum(t, dim=2), 2)         # (B,nc,cs,H)

    # --- intra-chunk (per-head decay between positions) -------------------
    rep = H // G
    att = einsum("bnigm,bnjgm->bngij", Ch.float(), Bh.float())
    att = torch.repeat_interleave(att, rep, dim=2)                # (B,nc,H,cs,cs)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,nc,cs,cs,H)
    decay = decay.permute(0, 1, 4, 2, 3)                          # (B,nc,H,cs,cs)
    causal = mesh_tensor(h, lambda sh: torch.ones(
        sh, dtype=torch.bool, device=h.device).tril(), (cs, cs))
    # the decay above the diagonal (j > i) is positive and can overflow exp;
    # the where drops those entries, but their gradient would be 0·inf = NaN
    # (the reference's is). Masking them to -inf first leaves the forward
    # bit for bit as it was and the gradient finite.
    decay = decay.masked_fill(~causal, float("-inf"))
    att = torch.where(causal, att * torch.exp(decay), 0.0)
    att = att * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = einsum("bnhij,bnjhp->bnihp", att.to(xh.dtype), xh)

    # --- chunk-local states + inter-chunk scan (cheap) ---------------------
    w_local = torch.exp(cum[:, :, -1:, :] - cum) * dtc            # (B,nc,cs,H)
    state_loc = einsum("bnjgm,bnjh,bnjhp->bnhmp", Bh.float(), w_local,
                             xh.float())                          # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)
    state = mesh_tensor(h, lambda sh: torch.zeros(sh, dtype=F32,
                                                  device=h.device),
                        (B_, H, N, P), ("dp", None, None, None))
    prev = []
    for c in range(nc):
        prev.append(state)                                        # PREVIOUS
        state = state * chunk_decay[:, c, :, None, None] + state_loc[:, c]
    # lint: ok(R001) the chunk states share one placement and stack on a new axis: DTensor keeps it and runs no collective (tests/test_torch_lm_sharded.py)
    prev_states = torch.stack(prev, dim=1)                        # (B,nc,H,N,P)

    Ch_h = torch.repeat_interleave(Ch, rep, dim=3).reshape(B_, nc, cs, H, N)
    y_inter = einsum("bnihm,bnhmp->bnihp",
                           (Ch_h * torch.exp(cum)[..., None]).float(),
                           prev_states)
    y = (y_intra.float() + y_inter
         + xh.float() * p["d_skip"][:, None])
    # (DTensor has no view rule merging chunks × positions or heads × dims
    # while they are sharded: they are gathered for the reshape)
    y = whole(y, 1, 2, 3, 4).reshape(B_, S, d_in)[:, :S_real]
    y = y * F.silu(z.float())
    y = rms_norm(y.to(h.dtype), p["out_ln"], cfg.norm_eps)
    out = shard_res(h + einsum("bse,ed->bsd", y, p["w_out"]).to(h.dtype))
    if return_cache:
        k = s.d_conv - 1
        conv = conv_in[:, max(S_real - k, 0):S_real].float()
        if conv.shape[1] < k:
            # a prompt shorter than the conv window: zeros before it (the
            # reference's slice keeps fewer rows, and its decode then fails)
            conv = pad_(conv, (0, 0, k - conv.shape[1], 0))
        return out, {"conv": conv, "state": state}
    return out


def mamba2_cache_spec(cfg: ArchConfig, batch: int) -> dict:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {
        "conv": PSpec((batch, s.d_conv - 1, conv_dim),
                      ("batch", None, "mlp"), init="zeros", dtype=F32),
        "state": PSpec((batch, H, s.d_state, s.head_dim),
                       ("batch", "heads", None, None), init="zeros",
                       dtype=F32),
    }


def mamba2_decode(p: dict, h: torch.Tensor, cache: dict, cfg: ArchConfig):
    """Single-token recurrent step. h: (B, 1, d). Writes the new conv
    window and state into ``cache`` in place and returns it."""
    s = cfg.ssm
    B_, _, d = h.shape
    d_in = s.expand * d
    H, P, N, G = d_in // s.head_dim, s.head_dim, s.d_state, s.n_groups
    x0 = rms_norm(h, p["ln"], cfg.norm_eps)
    z, conv_in, dt = _mamba_proj(p, x0, cfg)
    hist = concat_rows([cache["conv"], conv_in.float()], axis=1,
                       labels=("dp", None, "model"))              # (B,k,conv)
    conv_out = F.silu(einsum("bkc,kc->bc", hist, p["conv_w"].float())
                      + p["conv_b"].float())
    xin = conv_out[:, :d_in].reshape(B_, H, P)
    Bc = conv_out[:, d_in:d_in + G * N].reshape(B_, G, N)
    Cc = conv_out[:, d_in + G * N:].reshape(B_, G, N)
    rep = H // G
    Bh = torch.repeat_interleave(Bc, rep, dim=1)                  # (B,H,N)
    Chh = torch.repeat_interleave(Cc, rep, dim=1)
    a = -torch.exp(p["a_log"])
    dts = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    dec = torch.exp(dts * a)                                      # (B,H)
    new_state = (cache["state"] * dec[..., None, None]
                 + einsum("bhm,bh,bhp->bhmp", Bh, dts, xin.float()))
    y = einsum("bhm,bhmp->bhp", Chh, new_state) \
        + xin.float() * p["d_skip"][:, None]
    y = y.reshape(B_, 1, d_in) * F.silu(z.float())
    y = rms_norm(y.to(h.dtype), p["out_ln"], cfg.norm_eps)
    out = h + einsum("bse,ed->bsd", y, p["w_out"]).to(h.dtype)
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(new_state)
    return out, cache


# ==================================================================== RWKV6
def rwkv6_spec(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    H, K = cfg.n_heads, cfg.dh
    lora = 64
    return {
        "ln1": PSpec((d,), ("embed",), init="ones"),
        "ln2": PSpec((d,), ("embed",), init="ones"),
        # time-mix (wkv6)
        "mu_x": PSpec((d,), ("embed",), init="zeros", dtype=F32),
        "mu_rkvwg": PSpec((5, d), (None, "embed"), init="zeros", dtype=F32),
        "ddl_w1": PSpec((d, 5 * 32), ("embed", None)),
        "ddl_w2": PSpec((5, 32, d), (None, None, "embed")),
        "w_r": PSpec((d, H, K), ("embed", "heads", "head_dim")),
        "w_k": PSpec((d, H, K), ("embed", "heads", "head_dim")),
        "w_v": PSpec((d, H, K), ("embed", "heads", "head_dim")),
        "w_g": PSpec((d, H, K), ("embed", "heads", "head_dim")),
        "decay_base": PSpec((H, K), ("heads", "head_dim"), init="zeros",
                            dtype=F32),
        "decay_w1": PSpec((d, lora), ("embed", None)),
        "decay_w2": PSpec((lora, H, K), (None, "heads", "head_dim")),
        "bonus_u": PSpec((H, K), ("heads", "head_dim"), init="zeros",
                         dtype=F32),
        "gn_scale": PSpec((H, K), ("heads", "head_dim"), init="ones"),
        "w_o": PSpec((H, K, d), ("heads", "head_dim", "embed")),
        # channel-mix
        "mu_ck": PSpec((d,), ("embed",), init="zeros", dtype=F32),
        "mu_cr": PSpec((d,), ("embed",), init="zeros", dtype=F32),
        "cm_k": PSpec((d, cfg.d_ff), ("embed", "mlp")),
        "cm_v": PSpec((cfg.d_ff, d), ("mlp", "embed")),
        "cm_r": PSpec((d, d), ("embed", "embed2")),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} with optional carried last token (decode)."""
    if last is None:
        return pad_(x, (0, 0, 1, 0))[:, :x.shape[1]]
    if x.shape[1] == 1:
        return last[:, None]
    return concat_rows([last[:, None], x[:, :-1]], axis=1,
                       labels=("dp", "model", None))


def _ddlerp(p: dict, x: torch.Tensor, xprev: torch.Tensor) -> list:
    """RWKV6 data-dependent token-shift: 5 mixed streams (r,k,v,w,g)."""
    xx = (xprev - x).float()
    base = x + xx * p["mu_x"]
    hidden = torch.tanh(einsum("bsd,de->bse", base.to(BF16), p["ddl_w1"]))
    # (the 5·32 axis is split on the local shards: DTensor's view rule
    # would shard the 5 unevenly)
    hidden = along(hidden, lambda t: t.reshape(*t.shape[:2], 5, 32), 2)
    dyn = einsum("bsfe,fed->fbsd", hidden, p["ddl_w2"]).float()
    # (the 5 streams stay whole: DTensor cannot unbind a sharded dim, and
    # would shard 5 unevenly)
    mixes = whole(p["mu_rkvwg"], 0, 1)[:, None, None] + whole(dyn, 0)  # (5,B,S,d)
    return [(x + xx * m).to(BF16) for m in whole(mixes, 0)]


def _wkv_scan(r, k, v, w, u, state):
    """Sequential wkv recurrence, vectorized over (B, heads).

    r,k,v: (B,T,H,K); w: per-step decay in (0,1) (B,T,H,K);
    state: (B,H,K,V). Returns out (B,T,H,V), final state.
    """
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B,H,K,V)
        outs.append(einsum("bhk,bhkv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = state * w[:, t, :, :, None] + kv
    # lint: ok(R001) the step outputs share one placement and stack on a new axis: DTensor keeps it and runs no collective (tests/test_torch_lm_sharded.py)
    return torch.stack(outs, dim=1), state


def rwkv6_apply(p: dict, h: torch.Tensor, cfg: ArchConfig,
                state: Optional[torch.Tensor] = None, shift_last1=None,
                shift_last2=None):
    """Full-sequence RWKV6 layer (time-mix + channel-mix); returns
    (h', final wkv state, last normed token of each mix)."""
    B_, S, d = h.shape
    H, K = cfg.n_heads, cfg.dh
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    xr, xk, xv, xw, xg = _ddlerp(p, x, _shift(x, shift_last1))
    def heads(x, w):
        return shard_act(einsum("bsd,dhk->bshk", x, w),
                         "dp", None, "model", None)
    r = heads(xr, p["w_r"]).float()
    k = heads(xk, p["w_k"]).float()
    v = heads(xv, p["w_v"]).float()
    g = F.silu(heads(xg, p["w_g"]))
    dec_dyn = einsum("bsd,dl->bsl", xw, p["decay_w1"])
    dec = p["decay_base"][None, None] + einsum(
        "bsl,lhk->bshk", torch.tanh(dec_dyn), p["decay_w2"]).float()
    w = torch.exp(-torch.exp(dec))                                # (B,S,H,K) in (0,1)

    st0 = (mesh_tensor(h, lambda sh: torch.zeros(sh, dtype=F32,
                                                 device=h.device),
                       (B_, H, K, K), ("dp", "model", None, None))
           if state is None else state)
    out, st = _wkv_scan(r, k, v, w, p["bonus_u"], st0)
    out = whole(out.reshape(B_, S, H, K), -1)
    # per-head group norm
    mu = out.mean(-1, keepdim=True)
    var = ((out - mu) ** 2).mean(-1, keepdim=True)
    out = (out - mu) * torch.rsqrt(var + 64e-5) * p["gn_scale"].float()
    out = (out * g.float()).to(h.dtype)
    h = h + einsum("bshk,hkd->bsd", out, p["w_o"]).to(h.dtype)

    # channel mix
    x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    x2p = _shift(x2, shift_last2)
    xk2 = (x2 + (x2p - x2) * p["mu_ck"]).to(BF16)
    xr2 = (x2 + (x2p - x2) * p["mu_cr"]).to(BF16)
    kk = shard_act(einsum("bsd,df->bsf", xk2, p["cm_k"]), "dp", None, "model")
    kk = torch.square(torch.relu(kk))
    cv = einsum("bsf,fd->bsd", kk, p["cm_v"])
    rr = torch.sigmoid(einsum("bsd,de->bse", xr2, p["cm_r"]))
    h = shard_res(h + (rr * cv).to(h.dtype))
    return h, st, x[:, -1], x2[:, -1]


def rwkv6_cache_spec(cfg: ArchConfig, batch: int) -> dict:
    H, K = cfg.n_heads, cfg.dh
    d = cfg.d_model
    return {
        "state": PSpec((batch, H, K, K), ("batch", "heads", None, None),
                       init="zeros", dtype=F32),
        "last1": PSpec((batch, d), ("batch", None), init="zeros"),
        "last2": PSpec((batch, d), ("batch", None), init="zeros"),
    }


def rwkv6_decode(p: dict, h: torch.Tensor, cache: dict, cfg: ArchConfig):
    """One token; writes the new state and shift tokens into ``cache`` in
    place and returns it."""
    out, st, l1, l2 = rwkv6_apply(p, h, cfg, state=cache["state"],
                                  shift_last1=cache["last1"],
                                  shift_last2=cache["last2"])
    cache["state"].copy_(st)
    cache["last1"].copy_(l1)
    cache["last2"].copy_(l2)
    return out, cache
