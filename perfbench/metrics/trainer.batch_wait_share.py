"""Share of the window's step time the trainer spent obtaining batches
(``GNNTrainer.history``: Σ ``host_s`` / Σ ``time_s``), in %. Moves
``train_nodes_per_s``: a step waits on the host's batch build."""


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    total = sum(r["time_s"] for r in rec["steps"])
    return 100.0 * sum(r["host_s"] for r in rec["steps"]) / total
