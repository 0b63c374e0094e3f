"""Device time of the attention aggregation a step: the profiler's time of
the kernels named ``gat_attn_*`` (``csrc/gat_attention.cu``: the forward
and the backward's two passes) over the window's steps, ms. None where no
such kernel ran (an arch without attention, or a program without the
kernels). Moves the cell's throughput where the device sets the pace."""
KERNELS = ("gat_attn_",)


def kernel_seconds(rec) -> float:
    """The window's seconds in the attention kernels."""
    return sum(s for name, s in rec["device_ops"].items()
               if any(k in name for k in KERNELS))


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    t = kernel_seconds(rec)
    return 1e3 * t / len(rec["steps"]) if t > 0 else None
