"""Find a serving cell's knee once, on the card: the highest offered rate
whose p95 stays under a latency limit with no growing backlog.

    python3 perfbench/sweep.py --workload <cell> --rates 20,40,80 \
        --seconds 10 --limit-ms 100

One server (the cell's configuration, seed 0's weights) takes each rate's
open-loop schedule in turn. A backlog grows when the last fifth of a
window's requests waits more than twice as long as the first fifth, or
any request is not answered exactly. Prints one JSON line a rate, then the
knee; a cell's mix then fixes its rate at about four fifths of it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]

from perfbench import harness, loadgen  # noqa: E402


def main(argv=None) -> int:
    """The command line; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--limit-ms", type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from perfbench.drivers import serve
    cell, cfg, mix = harness.cell_files(harness.spec(), args.workload)
    ctx = harness.Ctx(cell=cell, config=cfg, traffic=mix, seed=0,
                      seconds=args.seconds, trace=False,
                      device=torch.device("cuda"), t_start=T_START)
    arrays = harness.dataset(cfg["dataset"])
    n = arrays["indptr"].shape[0] - 1
    prog = serve.Program(ctx, arrays)
    prog.send(*loadgen.schedule(mix, 1, mix["warmup_s"], n))
    knee, misses = None, 0
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        due, nodes = loadgen.schedule({**mix, "rate_rps": rate}, 100 + i,
                                      args.seconds, n)
        before = prog.server.stats()
        out = prog.send(due, nodes)
        after = prog.server.stats()
        lat = serve.latencies_ms(out)
        fifth = max(1, len(lat) // 5)
        head = statistics.fmean(lat[:fifth])
        tail = statistics.fmean(lat[-fifth:])
        grows = bool((not math.isfinite(tail)) or tail > 2 * head)
        p95 = harness.percentile(lat, 0.95)
        ok = bool(p95 <= args.limit_ms) and not grows
        row = {"rate_rps": rate, "requests": len(lat),
               "p50_ms": float(harness.percentile(lat, 0.5)),
               "p95_ms": float(p95),
               "p99_ms": float(harness.percentile(lat, 0.99)),
               "first_fifth_ms": head, "last_fifth_ms": tail,
               "not_exact": sum(1 for v in lat if not math.isfinite(v)),
               "batches": after["batches"] - before["batches"],
               "shed": after.get("shed", 0) - before.get("shed", 0),
               "meets_limit": ok}
        print(json.dumps(row), flush=True)
        if ok:
            knee, misses = rate, 0
        else:
            misses += 1
            if misses == 2:
                break
    prog.close()
    print(json.dumps({"workload": args.workload, "limit_ms": args.limit_ms,
                      "knee_rps": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
