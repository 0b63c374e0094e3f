"""One file per per-layer metric, ``metrics/<name>.py``, each with
``read(records) -> float | None`` over a traced run's records; None leaves
the metric out of the line."""
