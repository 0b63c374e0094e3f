"""llama-3.2-vision-90b — [hf:meta-llama/Llama-3.2-90B-Vision; unverified]
100L total (80 self-attn + 20 cross-attn image layers, one every 5),
d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Vision frontend is a STUB: precomputed patch embeddings (B, 1601, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    cross_every=5, frontend_tokens=1601,
    rope_theta=500_000.0,
    optimizer="adafactor", remat="full", fsdp_over_pod=True, microbatches=8,
)
