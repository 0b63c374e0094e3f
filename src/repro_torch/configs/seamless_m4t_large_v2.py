"""seamless-m4t-large-v2 — [arXiv:2308.11596; hf]
Enc-dec multimodal backbone: 24L encoder + 24L decoder, d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206. The speech/text frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, S_src, d_model)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    enc_layers=24, dec_layers=24,
    rope_theta=10_000.0,
    optimizer="adamw", remat="full",
    notes="24L enc + 24L dec backbone; modality frontend stubbed per assignment",
)
