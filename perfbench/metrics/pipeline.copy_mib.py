"""Bytes of a slot's batch tensors, which the pipeline pins and copies to
the card: the counter ``slot.copy_bytes`` of the step records, median, MiB.
Moves ``train_nodes_per_s``: fewer bytes, a shorter copy and pinning."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["slot"]["copy_bytes"] / 2**20 for s in rec["steps"]
            if "copy_bytes" in s.get("slot", {})]
    return statistics.median(vals) if vals else None
