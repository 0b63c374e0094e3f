"""ELL SpMM kernel launches a step: the median over the window's steps of
the step records' ``spmm_launches`` (``kernels.ell_spmm``'s two counters,
streaming and resident, which count launches of the CUDA kernels and never
their plain twins): each layer's buckets forward, and again over Aᵀ for
each input adjoint the backward takes. None where the records carry no
such count (a program without it)."""
import statistics


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    vals = [s["spmm_launches"] for s in rec["steps"] if "spmm_launches" in s]
    return float(statistics.median(vals)) if vals else None
