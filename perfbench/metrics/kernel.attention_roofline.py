"""The attention kernels' share of their roofline: the least time of the
attention aggregations the window's LMC steps need (``arch_<arch>.
attention_widths``: each layer's forward, and each of its ``backwards``
VJPs; ``yardstick.attention_work`` and ``attention_vjp_work`` over each
step's real batch and halo rows and edges) over the profiler's time of the
kernels named ``gat_attn_*``, in %. None where no such kernel ran."""
import importlib.util
from pathlib import Path

from perfbench.reference.lmc import arch_module
from perfbench.yardstick import (attention_vjp_work, attention_work,
                                 least_seconds)


def _kernel_seconds(rec) -> float:
    path = Path(__file__).with_name("step.attention_ms.py")
    spec = importlib.util.spec_from_file_location("perfbench_attention_ms",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_seconds(rec)


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    arch = arch_module(rec["config"]["arch"])
    if not hasattr(arch, "attention_widths"):
        return None
    t = _kernel_seconds(rec)
    if t <= 0:
        return None
    least = 0.0
    for nb, nh, ne in rec["step_stats"]:
        for heads, width, out, backwards in arch.attention_widths(
                rec["config"]):
            least += least_seconds(*attention_work(nb + nh, ne, heads, width,
                                                   out))
            least += backwards * least_seconds(*attention_vjp_work(
                nb + nh, ne, heads, width, out))
    return 100.0 * least / t
