"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell's configuration (``configs/``), traffic mix (``traffic/``)
and the mix's driver (``drivers/<kind>.py``) by name, runs it on the card,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit, which also close
standard error. Exits 2 without the card or cards the cell asks for, 3 if
the JAX package or JAX was loaded, and prints no result then.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    """The command line; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_cache_dirs()
    sp = harness.spec()
    cell, config, traffic = harness.cell_files(sp, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    ctx = harness.Ctx(cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda"),
                      t_start=T_START)
    res = driver.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = result_line(sp, args.workload, bool(args.trace), res, chips,
                       torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def result_line(sp: dict, workload: str, trace: bool, res: dict,
                chips: int, kind: str) -> dict:
    """The JSON result line of a driver's run, ``checks`` last."""
    units = {m["name"]: m["unit"] for m in sp["end_to_end"] + sp["per_layer"]}
    if trace:
        values = {n: harness.read_metric(n, res["records"])
                  for n in harness.per_layer_names(sp, workload)}
    else:
        values = {n: res["e2e"][n]
                  for n in harness.end_to_end_names(sp, workload)}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": {n: {"value": float(v), "unit": units[n]}
                        for n, v in values.items() if v is not None},
            "device": device}
    if trace:
        win = res["window"]
        device.update(busy_s=win.busy_s, window_s=win.window_s)
        line["breakdown"] = win.breakdown()
    line["checks"] = res["checks"]
    return line


if __name__ == "__main__":
    sys.exit(main())
