"""Device time a step: the union of the device's op intervals over the
traced window, over the window's steps, ms. Moves ``train_nodes_per_s``
where the device sets the pace."""


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"] or rec["busy_s"] <= 0:
        return None
    return 1e3 * rec["busy_s"] / len(rec["steps"])
