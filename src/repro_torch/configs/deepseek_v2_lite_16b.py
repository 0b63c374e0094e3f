"""deepseek-v2-lite-16b — [arXiv:2405.04434; hf]
27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.
MLA kv_lora=512 (no q compression), MoE: 2 shared + 64 routed, top-6,
first layer dense FFN (10944)."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  capacity_factor=1.25, first_dense_layers=1, d_ff_dense=10944),
    rope_theta=10_000.0,
    optimizer="adamw", remat="full",
)
