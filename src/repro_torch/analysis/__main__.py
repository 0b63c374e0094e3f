"""CLI: `python -m repro_torch.analysis [paths] [--rule R00x] [--json]
[--show-suppressed]`.

Exit status: 0 when every finding is pragma-suppressed, 1 when any
unsuppressed finding remains, 2 on usage errors. Findings print grep-style
(`path:line:col: R00x msg`) followed by a per-rule summary block; `--json`
replaces the human output with a machine-readable dump (summary still goes
to stderr). Without paths it reads this package's own tree
(`src/repro_torch`) and the repository's `chip_smoke.py`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.engine import all_rules, run_analysis, summarize


def default_paths() -> list[str]:
    """`src/repro_torch` and, beside `src/`, `chip_smoke.py` (when there)."""
    port = Path(__file__).resolve().parents[1]
    smoke = port.parents[1] / "chip_smoke.py"
    return [str(port)] + ([str(smoke)] if smoke.is_file() else [])


def main(argv=None) -> int:
    rules = all_rules()
    known = {r.id for r in rules}
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch/CUDA port: kernel, "
                    "autograd, sharding and queue invariants (R001-R006)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze (default: "
                         "src/repro_torch and chip_smoke.py)")
    ap.add_argument("--rule", action="append", metavar="R00x",
                    help="run only the given rule id (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON on stdout")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print pragma-suppressed findings")
    args = ap.parse_args(argv)

    if args.rule:
        bad = [r for r in args.rule if r not in known]
        if bad:
            print(f"unknown rule id(s): {', '.join(bad)} "
                  f"(known: {', '.join(sorted(known))})", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in set(args.rule)]

    findings = run_analysis(args.paths or default_paths(), rules)
    live = [f for f in findings if not f.suppressed]

    if args.json:
        json.dump([f.to_json() for f in findings], sys.stdout, indent=2)
        print()
        print(summarize(findings, rules), file=sys.stderr)
    else:
        shown = findings if args.show_suppressed else live
        for f in shown:
            print(f.format())
        if shown:
            print()
        print(summarize(findings, rules))
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
