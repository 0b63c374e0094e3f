"""A slot's batch copy to the card, between the CUDA events
``SubgraphPipeline._stage`` records on its side stream around it: the span
``pipeline.copy``, the step records' ``slot.copy_ms``, median ms. The start
event is recorded before the trainer's thread issues the batch's copies one
tensor at a time, so the span is the host issuing the copies plus their DMA:
where the interpreter is contended (two builder threads beside the trainer)
the issue dominates, and the DMA alone is the trace's ``Memcpy HtoD``. Moves
``train_nodes_per_s``: the copy holds the step where the step waits on it."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["slot"]["copy_ms"] for s in rec["steps"]
            if "copy_ms" in s.get("slot", {})]
    return statistics.median(vals) if vals else None
