"""Requests coalesced into one batch by the server over the window
(``GNNServer.stats()``: submitted / batches). Moves ``serve_p95_ms``."""


def read(rec):
    if rec.get("kind") != "serve" or rec["batches"] <= 0:
        return None
    return rec["submitted"] / rec["batches"]
