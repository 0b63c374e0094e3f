"""deepseek-v3-671b — [arXiv:2412.19437; hf]
61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
MLA (kv_lora=512, q_lora=1536), MoE: 1 shared + 256 routed top-8,
first 3 layers dense FFN (18432), 1 MTP module.

The optimizer and sharding knobs are the reference's (its DESIGN.md §7.7);
the port serves this config and does not yet train it."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  capacity_factor=1.25, first_dense_layers=3, d_ff_dense=18432),
    mtp_depth=1,
    rope_theta=10_000.0,
    optimizer="adafactor", remat="full", fsdp_over_pod=True,
    microbatches=16, grad_accum_dtype="bfloat16",
)
