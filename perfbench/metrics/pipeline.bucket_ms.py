"""The ELL bucketing of a slot's A and Aᵀ (``core/lmc.py::host_batch`` →
``kernels/ops.py::ell_from_coo``) as built on the pipeline's builder threads
in the window: the span ``pipeline.bucket``, the step records'
``slot.bucket_ms``, median ms. Moves ``train_nodes_per_s`` while the builders
set the pace."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["slot"]["bucket_ms"] for s in rec["steps"]
            if "bucket_ms" in s.get("slot", {})]
    return statistics.median(vals) if vals else None
