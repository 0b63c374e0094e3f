"""Pinning a slot's built batch (``Batch.pin_memory``) on the pipeline's
builder threads in the window: the span ``pipeline.pin``, the step records'
``slot.pin_ms``, median ms. Moves ``train_nodes_per_s`` while the builders
set the pace."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["slot"]["pin_ms"] for s in rec["steps"]
            if "pin_ms" in s.get("slot", {})]
    return statistics.median(vals) if vals else None
