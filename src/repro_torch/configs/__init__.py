"""Config registry: the ten LM architectures, a copy of the reference's
(``repro.configs``) so that the port imports nothing of it; the parity tests
hold every field equal."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      SSMConfig, ShapeConfig, SHAPES,
                                      applicable_shapes)

_ARCH_MODULES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-1.2b": "zamba2_1_2b",
    "rwkv6-7b": "rwkv6_7b",
    "internlm2-20b": "internlm2_20b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen2.5-32b": "qwen2_5_32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def reduced_config(name: str) -> ArchConfig:
    """CPU-runnable smoke config of the same family (small dims, same wiring)."""
    import dataclasses
    cfg = get_config(name)
    kw = dict(
        n_layers=min(cfg.n_layers, 4), d_model=64,
        n_heads=4, n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // cfg.n_heads)),
        d_ff=128, vocab=512, head_dim=16, remat="none", attn_chunk=64,
    )
    if cfg.enc_layers:
        kw.update(enc_layers=2, dec_layers=2, n_layers=4)
    if cfg.cross_every:
        kw.update(cross_every=2, frontend_tokens=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_expert=32,
            num_shared=min(cfg.moe.num_shared, 1), dispatch_chunks=2,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1), d_ff_dense=128)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, q_lora_rank=(16 if cfg.mla.q_lora_rank else 0),
            rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return dataclasses.replace(cfg, **kw)


__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "SHAPES", "applicable_shapes", "ARCH_NAMES", "get_config",
           "reduced_config"]
