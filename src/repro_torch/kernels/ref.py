"""Plain PyTorch oracles, line for line with ``repro.kernels.ref``.

They compute in the inputs' own dtype, exactly as the reference oracles do;
the kernels' plain twins (``ell_spmm_plain``, ``lmc_compensate_plain``)
instead mirror the kernels' f32 accumulation and casts.
"""
from __future__ import annotations

import torch


def ell_spmm_ref(nbr_idx: torch.Tensor, nbr_w: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """out[i] = Σ_k w[i,k] · h[idx[i,k]].   idx/w: (N, K); h: (M, D).

    Padding entries carry w == 0 (idx may point anywhere valid).
    """
    gathered = h[nbr_idx.long()]                   # (N, K, D)
    return torch.einsum("nk,nkd->nd", nbr_w, gathered)


def lmc_compensate_ref(store: torch.Tensor, gids: torch.Tensor,
                       beta: torch.Tensor, fresh: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """ĥ = mask · [(1-β)·store[gid] + β·fresh]   (paper Eq. 9 / Eq. 12)."""
    hist = store[gids.long()]                      # (N, D)
    return (mask[:, None] * ((1.0 - beta[:, None]) * hist
                             + beta[:, None] * fresh))


def degree_bucket_spmm_ref(indptr: torch.Tensor, indices: torch.Tensor,
                           weights: torch.Tensor,
                           h: torch.Tensor) -> torch.Tensor:
    """CSR segment-sum oracle of the bucketed production SpMM."""
    n = indptr.shape[0] - 1
    dst = torch.repeat_interleave(torch.arange(n, device=h.device),
                                  torch.diff(indptr))
    msgs = h[indices.long()] * weights[:, None]
    return msgs.new_zeros((n, h.shape[1])).index_add_(0, dst, msgs)
