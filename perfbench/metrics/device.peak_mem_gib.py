"""Peak device memory allocated during the training window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB.
Moves ``train_nodes_per_s``: what a larger batch could use."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("peak_window_bytes"):
        return None
    return rec["peak_window_bytes"] / 2**30
