"""CLI: ``python -m repro_torch.analysis [paths...] [--strict] [...]``.

The reference's CLI, with the same flags and exit codes, over the port.

Exit codes::

    0  clean (or, with --strict, nothing beyond the committed baseline)
    1  findings (default mode)
    2  --strict: NEW findings, or unjustified suppressions (live or
       baselined)

Run from the repo root; default scan roots are ``src/repro_torch`` (whose
benchmarks and examples live inside the package) and ``chip_smoke.py``
(tests intentionally excluded — fixtures contain deliberate violations).
The default baseline is the port's own,
``src/repro_torch/analysis/baseline.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.baseline import (
    baseline_problems,
    diff_against_baseline,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.core import RULES, load_context, rule_names, run_rules

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch static analysis: the repo's bug taxonomy "
        "as rules, over the port",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=list(DEFAULT_PATHS),
        help=f"files/dirs to scan (default: {' '.join(DEFAULT_PATHS)})",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="gate against the baseline: exit 2 on new findings or "
        "unjustified suppressions, 0 otherwise",
    )
    parser.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help=f"baseline file (default: {DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write the current findings + suppressions as the new baseline",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule subset (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    parser.add_argument(
        "--json", action="store_true", help="emit findings as JSON"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name in rule_names():
            r = RULES[name]
            print(f"{name:28s} [{r.family}] {r.description}")
        return 0

    root = Path.cwd()
    paths = [p for p in args.paths if (root / p).exists()]
    ctx = load_context(paths, root)
    selected = args.rules.split(",") if args.rules else None
    findings = run_rules(ctx, rules=selected)

    suppressions = []
    for f in ctx.files:
        suppressions.extend(f.suppressions())

    unsuppressed = [f for f in findings if not f.suppressed]
    n_sup = len(findings) - len(unsuppressed)

    if args.write_baseline:
        save_baseline(Path(args.baseline), findings, suppressions)
        print(
            f"wrote {args.baseline}: {len(unsuppressed)} finding(s), "
            f"{len(suppressions)} suppression(s)"
        )
        return 0

    if args.json:
        print(
            json.dumps(
                [dict(fingerprint=f.fingerprint, **f.to_dict())
                 for f in unsuppressed],
                indent=2,
            )
        )

    if not args.strict:
        if not args.json:
            for f in unsuppressed:
                print(f.render())
        print(
            f"{len(unsuppressed)} finding(s) "
            f"({n_sup} suppressed with justification)"
        )
        return 1 if unsuppressed else 0

    # --strict: compare against the committed baseline
    baseline = load_baseline(Path(args.baseline))
    problems = baseline_problems(baseline)
    new, known, stale = diff_against_baseline(findings, baseline)
    if not args.json:
        for f in new:
            print(f"NEW {f.render()}")
    for p in problems:
        print(f"BASELINE {p}")
    for fp in stale:
        print(f"stale baseline entry (no longer fires): {fp}")
    print(
        f"strict: {len(new)} new, {len(known)} baselined, {n_sup} "
        f"suppressed, {len(stale)} stale"
    )
    return 2 if (new or problems) else 0


if __name__ == "__main__":
    sys.exit(main())
