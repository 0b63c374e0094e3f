"""The checkpoint integrity idiom: crc32 over an array's contiguous bytes.

A copy of ``repro.checkpoint.manager.crc32_array`` (that module imports JAX);
the serving store's per-row ledger (serve/policy.py ``StoreIntegrity``) and a
future checkpoint manager share this one definition of "corrupt".
"""
from __future__ import annotations

import zlib

import numpy as np


def crc32_array(arr: np.ndarray) -> int:
    """crc32 of an array's contiguous bytes — the manifest integrity idiom."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())
