"""One batch built alone on the host after the window (the sampler's
subgraph and its ELL buckets, A and Aᵀ: ``host_batch(sampler.build_batch
(...))``), median ms. Moves ``train_nodes_per_s`` while the pipeline's
builders set the pace."""
import statistics


def read(rec):
    if rec.get("kind") != "train" or not rec.get("build_ms"):
        return None
    return statistics.median(rec["build_ms"])
