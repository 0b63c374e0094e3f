"""The yardstick: the card's published peaks and the least work of the
kernels whose roofline shares the benchmark reports.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3) at its 700 W
limit: 3.35 TB/s of device memory and 67 TFLOP/s in f32 outside the
tensor cores (the configurations run f32 with TF32 off). The least work of
a call counts each input byte read once and each output byte written once,
from the real (non-padding) rows and edges, whatever the implementation
reads again or pads: the same work for any kernel that computes the call.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32 = 4
INDEX = 4


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the memory time and the compute time at the peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def spmm_work(rows: int, edges: int, width: int) -> tuple:
    """``out = A h`` over a subgraph of ``rows`` real rows and ``edges`` real
    edges: h read once and out written once (``rows × width`` f32 each),
    each edge's source index and f32 weight read once; a multiply-add per
    edge and column. Returns ``(bytes, flops)``."""
    return (2 * rows * width * F32 + edges * (INDEX + F32),
            2.0 * edges * width)


def compensate_work(halo_rows: int, width: int) -> tuple:
    """``out = mask·((1-β)·store[gid] + β·fresh)`` over ``halo_rows`` real
    halo rows: the store rows, the fresh rows and the output once, and each
    row's gid, β and mask; five operations a element. Returns
    ``(bytes, flops)``."""
    return (3 * halo_rows * width * F32 + halo_rows * (INDEX + 2 * F32),
            5.0 * halo_rows * width)


def attention_work(rows: int, edges: int, heads: int, width: int,
                   out_width: int) -> tuple:
    """One GAT aggregation ``o_i = Σ_j α_ij z_j`` (``α`` the per-row,
    per-head softmax of ``LeakyReLU(u_j + v_i)``) over ``rows`` real rows
    and ``edges`` real edges, each row's self loop an edge more (E' =
    edges + rows): ``z`` (rows × heads × width), ``u`` and ``v`` (rows ×
    heads) read once, each edge's source index read once, the output (rows
    × out_width) written once; per edge and head the score (add, LeakyReLU),
    the max, the exponential and the sum (5) and a multiply-add per feature.
    Returns ``(bytes, flops)``."""
    e = edges + rows
    return ((rows * heads * (width + 2) + rows * out_width) * F32
            + e * INDEX, e * heads * (2.0 * width + 5.0))


def attention_vjp_work(rows: int, edges: int, heads: int, width: int,
                       out_width: int) -> tuple:
    """The VJP of :func:`attention_work`'s aggregation: ``z``, the output's
    cotangent, ``u``, ``v`` and the source indices read once; ``dz``,
    ``du`` and ``dv`` written once; per edge and head the softmax recomputed
    and taken back (8) and two multiply-adds per feature (``dα`` and
    ``dz``). Returns ``(bytes, flops)``."""
    e = edges + rows
    return ((2 * rows * heads * width + rows * out_width
             + 4 * rows * heads) * F32 + e * INDEX,
            e * heads * (4.0 * width + 8.0))
