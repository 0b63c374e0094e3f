"""One driver per kind of entry point, found by the traffic mix's
``driver`` key: ``drivers/<kind>.py`` with ``run(ctx) -> dict``."""
