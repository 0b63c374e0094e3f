"""Readings that the limits of ``correct`` are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \
        --control 3 --faults 3 [--seconds 30] [--out <jsonl>]

In one process (the graph, the program's partition and the reference's
are made once): the sound program on ``--seeds`` seeds (its numbers'
lower readings), the control on ``--control`` of them (the reference in
the program's place with TF32 GEMMs, the precision below the configured
f32), and for a training cell each planted fault (``faults.TRAIN``) on
``--faults`` seeds. A serving cell's sound readings run the window at the
mix's rate for ``--seconds``. Every reading is judged as a run judges it
(``harness.judge`` with the configuration's limits). Prints one JSON line a
reading, with its ``correct``, then the summary: per number, the largest
sound reading and the smallest reading of the control and of each fault,
and per kind of reading how many came out correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]

from perfbench import checks, faults, harness  # noqa: E402

SEED_BASE = 3_000_000_019


def seeds(count: int, offset: int = 0) -> list:
    """The calibration's seeds: large, fixed, distinct."""
    return [SEED_BASE + 7919 * (offset + i) for i in range(count)]


def calibrate_train(ctx, count, control, n_faults, emit) -> None:
    """Sound, control and fault readings of a training cell."""
    import torch
    from perfbench.drivers import train
    cfg, mix = ctx.config, ctx.traffic
    arrays = harness.dataset(cfg["dataset"])
    rparts = train.reference_parts(cfg, arrays)
    parts, refs = None, {}
    for seed in seeds(count):
        c = harness.Ctx(**{**ctx.__dict__, "seed": seed})
        prog = train.Program(c, arrays, parts)
        parts = prog.parts
        got = prog.first_steps()
        weights = prog.weights
        prog.close()
        del prog
        ref = train.reference_readings(cfg, mix, arrays, weights, seed,
                                       ctx.device, rparts)
        refs[seed] = (ref, weights)
        emit("sound", seed, *checks.train_numbers(got, ref))
    for seed in seeds(control):
        ref, weights = refs[seed]
        tf = train.reference_readings(cfg, mix, arrays, weights, seed,
                                      ctx.device, rparts, tf32=True)
        emit("control", seed, *checks.train_numbers(tf, ref))
    for name, plant in faults.TRAIN.items():
        for seed in seeds(n_faults):
            c = harness.Ctx(**{**ctx.__dict__, "seed": seed})
            prog = train.Program(c, arrays, parts)
            plant(prog)
            got = prog.first_steps()
            prog.close()
            del prog
            gc.collect()
            torch.cuda.empty_cache()
            emit(f"fault:{name}", seed,
                 *checks.train_numbers(got, refs[seed][0]))


def calibrate_serve(ctx, count, control, emit) -> None:
    """Sound readings (a window each) and control readings of a serving
    cell."""
    from perfbench import loadgen
    from perfbench.drivers import serve
    from perfbench.reference.serve import full_logits
    cfg, mix = ctx.config, ctx.traffic
    arrays = harness.dataset(cfg["dataset"])
    n = arrays["indptr"].shape[0] - 1
    for k, seed in enumerate(seeds(count)):
        c = harness.Ctx(**{**ctx.__dict__, "seed": seed})
        prog = serve.Program(c, arrays)
        due, nodes = loadgen.schedule(mix, prog.seed, ctx.seconds, n)
        out = prog.send(due, nodes)
        served = [(nodes[i], r.logits) for i, r in enumerate(out["resp"])
                  if r is not None and r.status == "ok"]
        lat = serve.latencies_ms(out)
        weights = prog.weights
        prog.close()
        del prog
        ref = full_logits(cfg, arrays, weights, ctx.device)
        emit("sound", seed, {"logits": checks.serve_number(served, ref)},
             {"served": len(served), "p50_ms": harness.percentile(lat, .5),
              "p95_ms": harness.percentile(lat, .95)})
        if k < control:
            tf = full_logits(cfg, arrays, weights, ctx.device, tf32=True)
            tf_served = [(nd, tf[nd].cpu().numpy()) for nd, _ in served]
            emit("control", seed,
                 {"logits": checks.serve_number(tf_served, ref)}, {})
        del ref
        gc.collect()


def main(argv=None) -> int:
    """The command line; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config, traffic = harness.cell_files(harness.spec(), args.workload)
    ctx = harness.Ctx(cell=cell, config=config, traffic=traffic, seed=0,
                      seconds=args.seconds, trace=False,
                      device=torch.device("cuda"), t_start=T_START)
    rows = []
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, worst):
        correct, _ = harness.judge(numbers, config["limits"])
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               "correct": correct, "numbers": numbers, "worst": worst,
               "t": round(time.perf_counter() - T_START, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            print(json.dumps(row), file=out, flush=True)

    if traffic["driver"] == "train":
        calibrate_train(ctx, args.seeds, args.control, args.faults, emit)
    else:
        calibrate_serve(ctx, args.seeds, args.control, emit)
    summary, judged = {}, {}
    for r in rows:
        for name, v in r["numbers"].items():
            s = summary.setdefault(name, {})
            key = "lower" if r["kind"] == "sound" else r["kind"]
            s[key] = (max if key == "lower" else min)(s.get(key, v), v)
        j = judged.setdefault(r["kind"], {"correct": 0, "readings": 0})
        j["correct"] += r["correct"]
        j["readings"] += 1
    last = json.dumps({"workload": args.workload, "summary": summary,
                       "judged": judged})
    print(last, flush=True)
    if out:
        print(last, file=out, flush=True)
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
