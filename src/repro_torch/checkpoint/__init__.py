"""Checkpoint integrity helpers (the checkpoint manager comes with training)."""
from repro_torch.checkpoint.manager import crc32_array

__all__ = ["crc32_array"]
