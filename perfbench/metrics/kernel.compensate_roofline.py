"""The halo compensation kernels' share of their roofline: the least time
of the compensations an LMC step needs (each layer's forward, Eq. 9, and
each layer's adjoint past the first, Eq. 12; ``yardstick.compensate_work``
over the step's real halo rows) over the profiler's time of the
compensation kernels, in %. Moves ``train_nodes_per_s``."""
from perfbench.yardstick import compensate_work, least_seconds

KERNELS = ("compensate_kernel", "compensate_resident_kernel")


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    t = sum(s for name, s in rec["device_ops"].items()
            if any(k in name for k in KERNELS))
    if t <= 0:
        return None
    cfg = rec["config"]
    calls = 2 * cfg["num_layers"] - 1
    least = sum(calls * least_seconds(*compensate_work(nh, cfg["hidden_dim"]))
                for _, nh, _ in rec["step_stats"])
    return 100.0 * least / t
