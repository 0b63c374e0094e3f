"""The span ``pipeline.ell`` of a slot: the CUDA events that
``SubgraphPipeline._stage`` records on its side stream around
``Batch.bucketed``, right after the batch's copy; the step records'
``slot.ell_ms``, median ms. The events bracket the build of the slot's ELL
buckets (A and Aᵀ) on the card from the copied COO, and also every gap in
which the side stream waits for the trainer's thread to issue the build's
next operation: where that thread shares the host with the builder
threads, the span is mostly that issue time, not the build's device time
(the kernels' and sorts' own time is in the device trace). A program that
buckets on the host has no such span, and the metric is left out. Moves
``train_nodes_per_s``: the step waits on the build where the build holds
it."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["slot"]["ell_ms"] for s in rec["steps"]
            if "ell_ms" in s.get("slot", {})]
    return statistics.median(vals) if vals else None
