"""Verifiable checkpoints in the reference's format 2, the crc32 idiom, and
the resharding of whole trees across row-block worlds."""
from repro_torch.checkpoint.manager import (CheckpointError, CheckpointManager,
                                            crc32_array, reshard, unshard)

__all__ = ["CheckpointError", "CheckpointManager", "crc32_array", "reshard",
           "unshard"]
