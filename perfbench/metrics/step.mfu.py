"""The whole step's share of the card's f32 peak: the model FLOPs of every
step in the window (``arch_<arch>.step_flops``: the LMC forward and its
backward over the step's real batch and halo rows and edges; no padding or
recomputation) over the window's seconds × 67 TFLOP/s, in %. Moves
``train_nodes_per_s``; bounds every kernel's roofline share."""
from perfbench.reference.lmc import arch_module
from perfbench.yardstick import F32_FLOPS_PER_S


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"] or rec["busy_s"] <= 0:
        return None
    cfg = rec["config"]
    arch = arch_module(cfg["arch"])
    flops = sum(arch.step_flops(cfg, nb + nh, nb, ne)
                for nb, nh, ne in rec["step_stats"])
    return 100.0 * flops / (rec["window_s"] * F32_FLOPS_PER_S)
