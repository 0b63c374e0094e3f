"""Verifiable checkpoints in the reference's format 2, and the crc32 idiom."""
from repro_torch.checkpoint.manager import (CheckpointError, CheckpointManager,
                                            crc32_array)

__all__ = ["CheckpointError", "CheckpointManager", "crc32_array"]
