"""Attention kernel launches a step: the median over the window's steps of
the step records' ``attn_launches`` (``kernels.gat_attention``'s counter,
which counts launches of the CUDA kernels and never their plain twins). 0
means the step aggregated in plain PyTorch; None where the records carry no
such count (a program without it) or the arch has no attention."""
import statistics

from perfbench.reference.lmc import arch_module


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    if not hasattr(arch_module(rec["config"]["arch"]), "attention_widths"):
        return None
    vals = [s["attn_launches"] for s in rec["steps"] if "attn_launches" in s]
    return float(statistics.median(vals)) if vals else None
