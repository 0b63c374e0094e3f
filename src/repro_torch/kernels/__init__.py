"""Hand-written Hopper kernels for the paper's compute hot spots.

  ell_spmm.py    — one ELL bucket's SpMM: CUDA kernel (csrc/ell_spmm.cu),
                   wrapper with a launch counter, plain PyTorch twin
  compensate.py  — fused gather + convex combination of LMC Eq. (9)/(12):
                   CUDA kernel (csrc/compensate.cu), wrapper, plain twin
  ops.py         — degree-bucketed production SpMM + compensate wrappers
                   (forward only), bulk-numpy ELL construction, AggregateFn
  build.py       — nvcc build of csrc/*.cu for sm_90a, ctypes loading
  ref.py         — plain PyTorch oracles mirroring repro.kernels.ref

A wrapper runs its plain twin only for CPU tensors; for a CUDA tensor it
launches its kernel or raises.
"""
from repro_torch.kernels.ops import (ELLCapacityError, ELLGraph, build_ell,
                                     bucketed_spmm, ell_aggregate_fn,
                                     ell_from_coo, fixed_row_capacity,
                                     lmc_compensate)
from repro_torch.kernels.ell_spmm import ell_spmm
from repro_torch.kernels.compensate import lmc_compensate_kernel
from repro_torch.kernels.build import build_kernels
from repro_torch.kernels import ref

__all__ = ["ELLCapacityError", "ELLGraph", "build_ell", "ell_from_coo",
           "fixed_row_capacity", "bucketed_spmm", "ell_spmm",
           "lmc_compensate", "lmc_compensate_kernel", "ell_aggregate_fn",
           "build_kernels", "ref"]
