"""The sampler's subgraph of a schedule slot (``clusters_at`` and
``ClusterSampler.build_batch``) as built on the pipeline's builder threads in
the window, beside the other builder and the trainer: the span
``pipeline.sample``, the step records' ``slot.sample_ms``, median ms. Moves
``train_nodes_per_s`` while the builders set the pace."""
import statistics


def read(rec):
    if rec.get("kind") != "train":
        return None
    vals = [s["slot"]["sample_ms"] for s in rec["steps"]
            if "sample_ms" in s.get("slot", {})]
    return statistics.median(vals) if vals else None
