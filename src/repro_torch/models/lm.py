"""LM assembly: configs -> (param specs, prefill / decode / loss fns).

A model is a list of **segments**, as in the reference (``repro.models.lm``);
each segment is ``count`` repeats of a block pattern whose per-layer
parameters are stacked on a leading layer axis. The reference scans a
segment with ``lax.scan``; here a Python loop runs over the layer views
``p[i]``. ``train_loss`` is differentiable with respect to the parameter
tree it is given, through the reference's custom backward passes
(``layers.embed_lookup``, the MoE gathers of ``blocks``) and its remat
policy (``cfg.remat``: each stacked step checkpointed whole, or keeping
only its matmul outputs). Two build knobs are kept from the reference:

  depth_profile: {segment_name: count} — shrink depth per segment;
  unroll=True — the reference's cost-extraction build: no attention KV
      chunking, one MoE dispatch chunk and no remat.

:class:`LM` is an ``nn.Module`` that owns the reference's parameter tree in
the reference's layout (``params()``), so converting reference parameters is
leaf for leaf (``repro_torch.convert.lm_params_from_reference``).

The vocabulary is padded to a multiple of 2048, as in the reference, and the
logits span every padded column: greedy decoding over them can pick a
padded id (the embedding's padded rows are drawn at random too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (along, concat_rows, mesh_tensor,
                                       shard_act, shard_res)
from repro_torch.models import blocks as B
from repro_torch.models import ssm as S
from repro_torch.models.blocks import Ctx
from repro_torch.models.layers import (decode_attention, einsum,
                                       embed_lookup, rms_norm,
                                       softmax_cross_entropy, BF16)
from repro_torch.models.spec import (PSpec, abstract, materialize, tree_leaves,
                                     tree_map)

VOCAB_ALIGN = 2048


def _pad_vocab(v: int) -> int:
    return ((v + VOCAB_ALIGN - 1) // VOCAB_ALIGN) * VOCAB_ALIGN


def _positions(ref: torch.Tensor, bsz: int, seq: int) -> torch.Tensor:
    """(bsz, seq) absolute positions on ``ref``'s device and mesh."""
    return mesh_tensor(ref, lambda s: torch.arange(
        seq, device=ref.device).expand(bsz, -1), (bsz, seq))


def _roll(tokens: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll`` along the sequence (DTensor has no rule for roll in
    every torch release: on a mesh it runs on the local rows)."""
    return along(tokens, lambda t: torch.roll(t, shift, dims=1), 1)


def _drop_last(mask: torch.Tensor, n: int) -> torch.Tensor:
    """``mask`` with its last ``n`` columns zeroed."""
    seq = mask.shape[1]
    col = mesh_tensor(mask, lambda s: torch.arange(seq, device=mask.device),
                      (seq,))
    return torch.where(col < seq - n, mask, 0.0)


def _stack(spec_tree, count: int):
    return tree_map(
        lambda s: PSpec((count,) + s.shape, ("layers",) + s.logical,
                        init=s.init, scale=s.scale, dtype=s.dtype),
        spec_tree)


def _at(tree, i: int):
    """Layer ``i``'s view of a stacked tree (views: in-place writes land in
    the stacked tensors)."""
    return tree_map(lambda a: a[i], tree)


def _layers(tree, count: int) -> list:
    """The ``count`` per-layer views of a stacked tree, from one ``unbind``
    per leaf: autograd then stacks the layers' gradients into the leaf's
    once, instead of adding ``count`` full-size zero-padded copies."""
    cols = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda c: c[i], cols) for i in range(count)]


# the reference's "dots" policy (jax.checkpoint_policies.checkpoint_dots):
# keep every matmul's output, recompute the rest in the backward
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def _save_dots():
    return create_selective_checkpoint_contexts(_DOTS)


def _stack_trees(trees: list):
    """Stack a list of same-structured trees on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    # lint: ok(R001) one cache leaf per layer, all on one placement, stacked on a new leading axis: DTensor keeps it and runs no collective (tests/test_torch_lm_sharded.py)
    return torch.stack(trees)


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kind: str
    count: int
    layer_spec: dict      # one layer's PSpec tree (unstacked)
    inner: int = 1        # inner repeats inside one stacked step


class LM(nn.Module):
    """A language model of one ArchConfig: specs, parameters and apply fns.

    ``device=None`` means the CUDA card (raises without one); parameters and
    caches live on ``self.device``. Parameters exist after ``init_params``
    or ``load_params``.
    """

    def __init__(self, cfg: ArchConfig, *,
                 depth_profile: Optional[dict[str, int]] = None,
                 unroll: bool = False, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.unroll = unroll
        self.vpad = _pad_vocab(cfg.vocab)
        self.segments = self._plan_segments(cfg, depth_profile or {})
        if unroll:
            kw: dict[str, Any] = {"attn_chunk": 1 << 30}
            if cfg.moe is not None:
                kw["moe"] = dataclasses.replace(cfg.moe, dispatch_chunks=1)
            self.cfg = dataclasses.replace(cfg, **kw)
        self._tree: Optional[dict] = None

    # ------------------------------------------------------------ planning
    @staticmethod
    def _plan_segments(cfg: ArchConfig, prof: dict[str, int]) -> list[Segment]:
        segs: list[Segment] = []

        def n(name, default):
            return max(int(prof.get(name, default)), 0)

        if cfg.family == "dense":
            segs.append(Segment("blocks", "dense", n("blocks", cfg.n_layers),
                                {"attn": B.attn_spec(cfg), "mlp": B.mlp_spec(cfg)}))
        elif cfg.family == "moe":
            fd = cfg.moe.first_dense_layers
            attn_spec = B.mla_spec(cfg) if cfg.mla else B.attn_spec(cfg)
            if fd:
                segs.append(Segment(
                    "dense_blocks", "moe_dense", n("dense_blocks", fd),
                    {"attn": dict(attn_spec),
                     "mlp": B.mlp_spec(cfg, cfg.moe.d_ff_dense)}))
            segs.append(Segment(
                "moe_blocks", "moe", n("moe_blocks", cfg.n_layers - fd),
                {"attn": dict(attn_spec), "moe": B.moe_spec(cfg)}))
        elif cfg.family == "ssm":
            segs.append(Segment("blocks", "rwkv", n("blocks", cfg.n_layers),
                                S.rwkv6_spec(cfg)))
        elif cfg.family == "hybrid":
            groups, tail = divmod(cfg.n_layers, cfg.attn_every)
            segs.append(Segment(
                "groups", "mamba_group", n("groups", groups),
                {"mamba": _stack(S.mamba2_spec(cfg), cfg.attn_every)},
                inner=cfg.attn_every))
            if tail:
                segs.append(Segment("tail", "mamba", n("tail", tail),
                                    S.mamba2_spec(cfg)))
        elif cfg.family == "vlm":
            g = cfg.cross_every
            n_cross = cfg.n_layers // g
            segs.append(Segment(
                "groups", "vlm_group", n("groups", n_cross),
                {"self": _stack({"attn": B.attn_spec(cfg),
                                 "mlp": B.mlp_spec(cfg)}, g - 1),
                 "cross": {"attn": B.cross_attn_spec(cfg),
                           "mlp": B.mlp_spec(cfg)}},
                inner=g - 1))
        elif cfg.family == "encdec":
            segs.append(Segment("encoder", "enc", n("encoder", cfg.enc_layers),
                                {"attn": B.attn_spec(cfg), "mlp": B.mlp_spec(cfg)}))
            segs.append(Segment(
                "decoder", "dec", n("decoder", cfg.dec_layers),
                {"attn": B.attn_spec(cfg), "cross": B.cross_attn_spec(cfg),
                 "mlp": B.mlp_spec(cfg)}))
        else:
            raise ValueError(cfg.family)
        return segs

    # -------------------------------------------------------------- params
    def params_spec(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        spec: dict[str, Any] = {
            "embed": PSpec((self.vpad, d), ("vocab", "embed"), scale=0.01),
            "final_ln": PSpec((d,), ("embed",), init="ones"),
        }
        if not cfg.tie_embeddings:
            spec["head"] = PSpec((d, self.vpad), ("embed", "vocab"), scale=0.01)
        for seg in self.segments:
            spec[seg.name] = _stack(seg.layer_spec, seg.count)
        if cfg.shared_attn:
            spec["shared_attn"] = {"attn": B.attn_spec(cfg),
                                   "mlp": B.mlp_spec(cfg)}
        if cfg.mtp_depth:
            spec["mtp"] = {"proj": PSpec((2 * d, d), (None, "embed")),
                           "ln": PSpec((d,), ("embed",), init="ones"),
                           "attn": (B.mla_spec(cfg) if cfg.mla
                                    else B.attn_spec(cfg)),
                           "mlp": B.mlp_spec(cfg, cfg.d_ff or 4 * d)}
        return spec

    def init_params(self, generator: torch.Generator) -> dict:
        """Draw every leaf (normal·scale in f32, cast; or zeros / ones) on
        ``self.device`` from ``generator``, which must live there."""
        return self.load_params(
            materialize(self.params_spec(), generator, self.device))

    def load_params(self, tree: dict) -> dict:
        """Own ``tree`` (the reference's layout, tensors on ``self.device``)
        as this module's parameters; returns ``params()``."""
        want = {p: (s.shape, s.dtype) for p, s in tree_leaves(self.params_spec())}
        got = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves(tree)}
        if want != got:
            raise ValueError(f"parameter tree does not match the spec: "
                             f"{sorted(set(want.items()) ^ set(got.items()))}")
        self._parameters.clear()
        self._modules.clear()
        self._tree = self._register(self, tree)
        return self._tree

    @staticmethod
    def _register(module: nn.Module, tree: dict) -> dict:
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                child = nn.Module()
                module.add_module(k, child)
                out[k] = LM._register(child, v)
            else:
                param = nn.Parameter(v, requires_grad=False)
                module.register_parameter(k, param)
                out[k] = param
        return out

    def params(self) -> dict:
        if self._tree is None:
            raise RuntimeError("LM has no parameters: call init_params or "
                               "load_params first")
        return self._tree

    def abstract_params(self) -> dict:
        return abstract(self.params_spec())

    # ------------------------------------------------------- forward (loss)
    def _remat(self, fn, *args):
        """``fn(*args)`` under the reference's remat policy (``LM._remat``)
        when grad is on: ``"full"`` recomputes the whole stacked step in
        the backward, ``"dots"`` keeps its matmul outputs and recomputes the
        rest; ``"none"`` and ``unroll`` keep everything."""
        if self.cfg.remat == "none" or self.unroll or \
                not torch.is_grad_enabled():
            return fn(*args)
        if self.cfg.remat == "dots":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=_save_dots)
        return checkpoint(fn, *args, use_reentrant=False)

    def _block(self, seg: Segment, params: dict, h: torch.Tensor,
               lp: dict, ctx: Ctx) -> torch.Tensor:
        """One stacked step of ``seg`` (the reference's scan body)."""
        cfg = self.cfg
        kind = seg.kind
        if kind in ("dense", "moe_dense", "moe"):
            h = (B.mla_apply if cfg.mla else B.attn_apply)(lp["attn"], h, ctx, cfg)
            if kind == "moe":
                return B.moe_apply(lp["moe"], h, cfg)
            return B.mlp_apply(lp["mlp"], h, cfg)
        if kind == "rwkv":
            return S.rwkv6_apply(lp, h, cfg)[0]
        if kind == "mamba":
            return S.mamba2_apply(lp, h, cfg)
        if kind == "mamba_group":
            for i in range(seg.inner):
                h = S.mamba2_apply(_at(lp["mamba"], i), h, cfg)
            sp = params["shared_attn"]
            h = B.attn_apply(sp["attn"], h, ctx, cfg)
            return B.mlp_apply(sp["mlp"], h, cfg)
        if kind == "vlm_group":
            for i in range(seg.inner):
                sl = _at(lp["self"], i)
                h = B.attn_apply(sl["attn"], h, ctx, cfg)
                h = B.mlp_apply(sl["mlp"], h, cfg)
            h = B.cross_attn_apply(lp["cross"]["attn"], h, ctx, cfg)
            return B.mlp_apply(lp["cross"]["mlp"], h, cfg)
        if kind == "enc":
            h = B.attn_apply(lp["attn"], h, ctx, cfg, causal=False)
            return B.mlp_apply(lp["mlp"], h, cfg)
        if kind == "dec":
            h = B.attn_apply(lp["attn"], h, ctx, cfg)
            h = B.cross_attn_apply(lp["cross"], h, ctx, cfg)
            return B.mlp_apply(lp["mlp"], h, cfg)
        raise ValueError(kind)

    def _backbone(self, params: dict, h: torch.Tensor, ctx: Ctx,
                  seg_filter=None) -> torch.Tensor:
        for seg in self.segments:
            if seg_filter and seg.name not in seg_filter:
                continue
            for lp in _layers(params[seg.name], seg.count):
                h = self._remat(self._block, seg, params, h, lp, ctx)
        return h

    def _logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, params["final_ln"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        # vocab stays model-sharded: the head's gradient contraction then
        # gives (d, vpad/n_model) partials, not full (d, vpad) buffers
        h = shard_act(h, "dp", None, None)
        return shard_act(einsum("bsd,dv->bsv", h, w), "dp", None, "model")

    def _encode(self, params: dict, memory: torch.Tensor,
                ctx: Ctx) -> torch.Tensor:
        src_pos = _positions(memory, memory.shape[0], memory.shape[1])
        return self._backbone(params, memory, ctx._replace(positions=src_pos),
                              seg_filter={"encoder"})

    def train_loss(self, params: dict, batch: dict) -> torch.Tensor:
        """batch: tokens (B,S) int, loss_mask (B,S) f32 [, memory (B,T,d)].

        Differentiable in ``params``: pass a tree whose leaves require grad
        (``launch.steps.make_lm_train_step`` does) and call ``backward``
        or ``torch.autograd.grad`` on the result. The LM's own
        ``params()`` do not require grad."""
        cfg = self.cfg
        tokens = batch["tokens"]
        bsz, seq = tokens.shape
        pos = _positions(tokens, bsz, seq)
        ctx = Ctx(positions=pos, length=0, memory=batch.get("memory"))
        h = shard_res(embed_lookup(params["embed"], tokens))

        if cfg.family == "encdec":
            ctx = ctx._replace(memory=self._encode(params, batch["memory"], ctx))
            h = self._backbone(params, h, ctx, seg_filter={"decoder"})
        else:
            h = self._backbone(params, h, ctx)

        logits = self._logits(params, h)
        targets = _roll(tokens, -1)
        mask = _drop_last(batch["loss_mask"], 1)
        loss = softmax_cross_entropy(logits, targets, mask, cfg.vocab)

        if cfg.mtp_depth:
            # DeepSeek-V3 multi-token prediction: predict t+2 from (h_t, e_{t+1})
            mp = params["mtp"]
            nxt = embed_lookup(params["embed"], targets)
            h2 = einsum("bsd,de->bse",
                        concat_rows([h, nxt], axis=-1,
                                    labels=("dp", "model", None)),
                        mp["proj"])
            h2 = rms_norm(h2, mp["ln"], cfg.norm_eps)
            h2 = (B.mla_apply if cfg.mla else B.attn_apply)(mp["attn"], h2, ctx, cfg)
            h2 = B.mlp_apply(mp["mlp"], h2, cfg)
            logits2 = self._logits(params, h2)
            t2 = _roll(tokens, -2)
            mask2 = _drop_last(mask, 2)
            loss = loss + 0.3 * softmax_cross_entropy(logits2, t2, mask2,
                                                      cfg.vocab)
        return loss

    # --------------------------------------------------------- serve: caches
    def cache_spec(self, batch: int, max_seq: int) -> dict:
        cfg = self.cfg
        out: dict[str, Any] = {}
        for seg in self.segments:
            if seg.kind in ("dense", "moe_dense", "moe"):
                per = (B.mla_cache_spec(cfg, batch, max_seq) if cfg.mla
                       else B.attn_cache_spec(cfg, batch, max_seq))
                out[seg.name] = _stack(per, seg.count)
            elif seg.kind == "rwkv":
                out[seg.name] = _stack(S.rwkv6_cache_spec(cfg, batch), seg.count)
            elif seg.kind == "mamba":
                out[seg.name] = _stack(S.mamba2_cache_spec(cfg, batch), seg.count)
            elif seg.kind == "mamba_group":
                out[seg.name] = {
                    "mamba": _stack(_stack(S.mamba2_cache_spec(cfg, batch),
                                           seg.inner), seg.count),
                    "attn": _stack(B.attn_cache_spec(cfg, batch, max_seq),
                                   seg.count)}
            elif seg.kind == "vlm_group":
                out[seg.name] = {
                    "self": _stack(_stack(
                        B.attn_cache_spec(cfg, batch, max_seq), seg.inner),
                        seg.count),
                    "cross": _stack(B.attn_cache_spec(cfg, batch,
                                                      cfg.frontend_tokens),
                                    seg.count)}
            elif seg.kind == "dec":
                # the source length is not known here; the reference sizes
                # the cross cache as max_seq
                out[seg.name] = {
                    "self": _stack(B.attn_cache_spec(cfg, batch, max_seq),
                                   seg.count),
                    "cross": _stack(B.attn_cache_spec(cfg, batch, max_seq),
                                    seg.count)}
            # "enc": the encoder output is carried in ctx.memory, not a cache
        return out

    def abstract_cache(self, batch: int, max_seq: int) -> dict:
        return abstract(self.cache_spec(batch, max_seq))

    # ---------------------------------------------------------- serve: decode
    @torch.no_grad()
    def decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                    length, memory: Optional[torch.Tensor] = None):
        """One token for the whole batch. token (B,1) -> logits (B, vpad).

        ``length`` (an int or a 0-d tensor) is the number of positions
        already cached. The caches passed in are consumed: the new position
        is written into them in place, and the returned caches are the same
        tensors. Clone them first to keep the old state.
        """
        h = embed_lookup(params["embed"], token)
        ctx = Ctx(positions=None, length=int(length), memory=memory)
        new_caches: dict[str, Any] = {}
        for seg in self.segments:
            if seg.count == 0 or seg.kind == "enc":
                continue
            cache = caches[seg.name]
            for i in range(seg.count):
                h = self._decode_block(seg, params, h,
                                       _at(params[seg.name], i),
                                       _at(cache, i), ctx)
            new_caches[seg.name] = cache
        logits = self._logits(params, h)[:, 0]
        return logits, new_caches

    def _decode_block(self, seg: Segment, params: dict, h: torch.Tensor,
                      lp: dict, lc: dict, ctx: Ctx) -> torch.Tensor:
        cfg = self.cfg
        if seg.kind in ("dense", "moe_dense", "moe"):
            h, _ = (B.mla_decode if cfg.mla else B.attn_decode)(
                lp["attn"], h, lc, ctx, cfg)
            if seg.kind == "moe":
                return B.moe_apply(lp["moe"], h, cfg)
            return B.mlp_apply(lp["mlp"], h, cfg)
        if seg.kind == "rwkv":
            return S.rwkv6_decode(lp, h, lc, cfg)[0]
        if seg.kind == "mamba":
            return S.mamba2_decode(lp, h, lc, cfg)[0]
        if seg.kind == "mamba_group":
            for i in range(seg.inner):
                h, _ = S.mamba2_decode(_at(lp["mamba"], i), h,
                                       _at(lc["mamba"], i), cfg)
            sp = params["shared_attn"]
            h, _ = B.attn_decode(sp["attn"], h, lc["attn"], ctx, cfg)
            return B.mlp_apply(sp["mlp"], h, cfg)
        if seg.kind == "vlm_group":
            for i in range(seg.inner):
                sl = _at(lp["self"], i)
                h, _ = B.attn_decode(sl["attn"], h, _at(lc["self"], i), ctx, cfg)
                h = B.mlp_apply(sl["mlp"], h, cfg)
            h = self._cross_decode(lp["cross"]["attn"], h, lc["cross"])
            return B.mlp_apply(lp["cross"]["mlp"], h, cfg)
        if seg.kind == "dec":
            h, _ = B.attn_decode(lp["attn"], h, lc["self"], ctx, cfg)
            h = self._cross_decode(lp["cross"], h, lc["cross"])
            return B.mlp_apply(lp["mlp"], h, cfg)
        raise ValueError(seg.kind)

    def _cross_decode(self, p: dict, h: torch.Tensor,
                      cache: dict) -> torch.Tensor:
        """Cross-attention against a prefilled (encoder/image) KV cache,
        which stays as it is."""
        x = rms_norm(h, p["ln"], self.cfg.norm_eps)
        q = einsum("bsd,dhq->bshq", x, p["wq"])
        o = decode_attention(q, cache["k"], cache["v"], cache["k"].shape[1])
        return h + B.gate(p, h) * einsum("bshq,hqd->bsd", o,
                                         p["wo"]).to(h.dtype)

    # --------------------------------------------------------- serve: prefill
    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor, max_seq: int,
                memory: Optional[torch.Tensor] = None):
        """Process a full prompt, returning (last-position logits, caches)."""
        bsz, seq = tokens.shape
        pos = _positions(tokens, bsz, seq)
        ctx = Ctx(positions=pos, length=0, memory=memory)
        h = shard_res(embed_lookup(params["embed"], tokens))
        caches: dict[str, Any] = {}

        if self.cfg.family == "encdec":
            ctx = ctx._replace(memory=self._encode(params, memory, ctx))

        for seg in self.segments:
            if seg.count == 0 or seg.kind == "enc":
                continue
            per_layer = []
            for i in range(seg.count):
                h, c = self._prefill_block(seg, params, h,
                                           _at(params[seg.name], i), ctx,
                                           max_seq)
                per_layer.append(c)
            caches[seg.name] = _stack_trees(per_layer)
        logits = self._logits(params, h[:, -1:])[:, 0]
        return logits, caches

    def _prefill_block(self, seg: Segment, params: dict, h: torch.Tensor,
                       lp: dict, ctx: Ctx, max_seq: int):
        cfg = self.cfg
        if seg.kind in ("dense", "moe_dense", "moe"):
            pre = B.mla_prefill_cache if cfg.mla else B.attn_prefill_cache
            h, c = pre(lp["attn"], h, ctx, cfg, max_seq)
            if seg.kind == "moe":
                return B.moe_apply(lp["moe"], h, cfg), c
            return B.mlp_apply(lp["mlp"], h, cfg), c
        if seg.kind == "rwkv":
            h, st, l1, l2 = S.rwkv6_apply(lp, h, cfg)
            return h, {"state": st, "last1": l1, "last2": l2}
        if seg.kind == "mamba":
            return S.mamba2_apply(lp, h, cfg, return_cache=True)
        if seg.kind == "mamba_group":
            caches_m = []
            for i in range(seg.inner):
                h, cm_i = S.mamba2_apply(_at(lp["mamba"], i), h, cfg,
                                         return_cache=True)
                caches_m.append(cm_i)
            sp = params["shared_attn"]
            h, ca = B.attn_prefill_cache(sp["attn"], h, ctx, cfg, max_seq)
            h = B.mlp_apply(sp["mlp"], h, cfg)
            return h, {"mamba": _stack_trees(caches_m), "attn": ca}
        if seg.kind == "vlm_group":
            cs = []
            for i in range(seg.inner):
                sl = _at(lp["self"], i)
                h, c = B.attn_prefill_cache(sl["attn"], h, ctx, cfg, max_seq)
                h = B.mlp_apply(sl["mlp"], h, cfg)
                cs.append(c)
            h, cx = self._cross_prefill(lp["cross"]["attn"], h, ctx)
            h = B.mlp_apply(lp["cross"]["mlp"], h, cfg)
            return h, {"self": _stack_trees(cs), "cross": cx}
        if seg.kind == "dec":
            h, cself = B.attn_prefill_cache(lp["attn"], h, ctx, cfg, max_seq)
            h, cx = self._cross_prefill(lp["cross"], h, ctx)
            h = B.mlp_apply(lp["mlp"], h, cfg)
            return h, {"self": cself, "cross": cx}
        raise ValueError(seg.kind)

    def _cross_prefill(self, p: dict, h: torch.Tensor, ctx: Ctx):
        out, k, v = B.cross_attn_kv(p, h, ctx.memory, self.cfg)
        return out, {"k": k.to(BF16), "v": v.to(BF16)}
