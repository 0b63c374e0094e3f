"""Training throughput in a host-paced cell, in a traced run: the real
(non-padding) batch nodes of every step in the window over the window's
seconds, nodes/s, as the end-to-end ``train_nodes_per_s`` takes it where it
is held to a bound. In a cell whose host batch build sets the pace it
spreads with the shared host's speed (PERF.md §2), so it is read here, with
the profiler on, and bounds nothing."""


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"] \
            or rec.get("window_s", 0) <= 0:
        return None
    return rec["nodes"] / rec["window_s"]
