"""zamba2-1.2b — [arXiv:2411.15242; hf]
38L d_model=2048 d_ff=8192 vocab=32000, Mamba2 backbone with a *shared*
attention block applied every 6 Mamba layers (32H, kv=32), ssm_state=64.
Hybrid SSM -> runs long_500k."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
    attn_every=6, shared_attn=True,
    sub_quadratic=True,
    optimizer="adamw", remat="full", microbatches=4,
)
