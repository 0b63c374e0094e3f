"""Device time a served batch: the union of the device's op intervals over
the traced window, over the window's batches, ms. Moves
``serve_p50_ms``."""


def read(rec):
    if rec.get("kind") != "serve" or rec["batches"] <= 0 \
            or rec["busy_s"] <= 0:
        return None
    return 1e3 * rec["busy_s"] / rec["batches"]
