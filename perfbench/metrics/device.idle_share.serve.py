"""Share of the traced serving window in which no op ran on the device,
in %. Moves ``serve_p95_ms``."""


def read(rec):
    if rec.get("kind") != "serve" or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
