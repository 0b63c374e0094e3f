"""Share of the traced training window in which no op ran on the device
(1 - union of the device's op intervals / window), in %. Moves
``train_nodes_per_s``."""


def read(rec):
    if rec.get("kind") != "train" or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
