"""rwkv6-7b (Finch) — [arXiv:2404.05892; hf]
32L d_model=4096 (attention-free) d_ff=14336 vocab=65536,
data-dependent decay; head_dim 64. Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536, head_dim=64,
    ssm=SSMConfig(d_state=64, head_dim=64, chunk=128),
    sub_quadratic=True,
    optimizer="adamw", remat="full", microbatches=4,
    notes="wkv6 implemented in chunked matmul form (TPU-native, MXU-aligned)",
)
