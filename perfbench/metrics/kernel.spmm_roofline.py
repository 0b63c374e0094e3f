"""The aggregation kernels' share of their roofline: the least time of the
aggregations an LMC step needs (``arch_<arch>.spmm_widths``: each layer's
forward, and the backward over Aᵀ of each layer whose input has an
adjoint; ``yardstick.spmm_work`` over the step's real rows and edges) over
the profiler's time of the kernels doing the aggregation, in %. Moves
``train_nodes_per_s``."""
from perfbench.reference.lmc import arch_module
from perfbench.yardstick import least_seconds, spmm_work

KERNELS = ("ell_spmm",)   # csrc/ell_spmm.cu: streaming and resident


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    t = sum(s for name, s in rec["device_ops"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    cfg = rec["config"]
    widths = arch_module(cfg["arch"]).spmm_widths(cfg)
    least = sum(least_seconds(*spmm_work(nb + nh, ne, w))
                for nb, nh, ne in rec["step_stats"] for w in widths)
    return 100.0 * least / t
