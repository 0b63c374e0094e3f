"""qwen2.5-32b — [hf:Qwen/Qwen2.5-*; hf]
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064, QKV bias."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    optimizer="adamw", remat="full", microbatches=2,
)
