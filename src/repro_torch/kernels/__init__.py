"""Hand-written Hopper kernels for the paper's compute hot spots.

  ell_spmm.py    — one ELL bucket's SpMM: streaming and resident-source CUDA
                   kernels (csrc/ell_spmm.cu), each in a per-bucket and a
                   scatter form, wrappers with launch counters, plain twins
  compensate.py  — fused gather + convex combination of LMC Eq. (9)/(12):
                   streaming and resident-store CUDA kernels
                   (csrc/compensate.cu), wrappers, plain twin
  ops.py         — degree-bucketed production SpMM + compensate wrappers
                   (autograd Functions), bulk-numpy ELL construction,
                   AggregateFn
  ell_build.py   — the batch's ELL planned on the host (row counts,
                   capacities) and built on its device: the CUDA scatter
                   (csrc/ell_build.cu), its wrapper, launch counter and twin
  build.py       — nvcc build of csrc/*.cu for sm_90a, ctypes loading
  ref.py         — plain PyTorch oracles mirroring repro.kernels.ref

A wrapper runs its plain twin only for CPU tensors; for a CUDA tensor it
launches its kernel or raises.
"""
from repro_torch.kernels.ops import (ELLCapacityError, ELLGraph, build_ell,
                                     bucketed_spmm, ell_aggregate_fn,
                                     ell_from_coo, fixed_row_capacity,
                                     lmc_compensate)
from repro_torch.kernels.ell_spmm import (ell_spmm, ell_spmm_resident,
                                          ell_spmm_resident_scatter,
                                          ell_spmm_scatter)
from repro_torch.kernels.compensate import (lmc_compensate_kernel,
                                            lmc_compensate_resident)
from repro_torch.kernels.ell_build import ELLPlan, plan_ell
from repro_torch.kernels.build import build_kernels
from repro_torch.kernels import ref

__all__ = ["ELLCapacityError", "ELLGraph", "ELLPlan", "build_ell",
           "ell_from_coo", "plan_ell",
           "fixed_row_capacity", "bucketed_spmm", "ell_spmm",
           "ell_spmm_resident", "ell_spmm_scatter",
           "ell_spmm_resident_scatter", "lmc_compensate", "lmc_compensate_kernel",
           "lmc_compensate_resident", "ell_aggregate_fn", "build_kernels",
           "ref"]
