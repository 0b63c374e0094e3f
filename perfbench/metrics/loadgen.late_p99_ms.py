"""How late the load generator submitted, p99 over the window's requests,
ms: a stall in the harness shows here before it shows in the tails. Moves
``serve_p95_ms``."""
from perfbench.harness import percentile


def read(rec):
    if rec.get("kind") != "serve" or not rec["late_ms"]:
        return None
    return max(percentile(rec["late_ms"], 0.99), 0.0)
