"""Device choice for the package's entry points: the card unless told otherwise."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card, and raises if there is none.

    Pass ``device="cpu"`` to run on the CPU (the kernels' plain twins).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: repro_torch runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
