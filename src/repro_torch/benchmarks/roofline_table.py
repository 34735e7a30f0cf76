"""The roofline tables (port of the reference's
``benchmarks/roofline_table.py``).

``--miniconv`` renders the MiniConv encoder roofline derived from the
port's :class:`~repro_torch.core.passplan.PassPlan` — per-layer pass
count, samples a pixel against the shader budget, FLOPs and bytes moved —
so the table always agrees with what the kernels execute.

Without it, the table renders dry-run sweep results (JSONL, one row per
arch × shape × mesh, as ``python -m repro_torch.launch.dryrun --out``
writes them) with the dominant-term classification and the useful-FLOPs
ratio.

    python -m repro_torch.benchmarks.roofline_table --miniconv
    python -m repro_torch.benchmarks.roofline_table --glob 'rows/*.jsonl'
"""
from __future__ import annotations

import argparse
import glob
import json

HEADER = (f"{'arch':<24} {'shape':<12} {'mesh':<7} {'compute_s':>10} "
          f"{'memory_s':>10} {'coll_s':>9} {'bottleneck':<11} "
          f"{'useful':>7} {'peak/dev':>9}")


def load(paths):
    """Rows of the JSONL files in ``paths``, without error rows; of rows
    with one (arch, shape, mesh, overrides) key the later wins."""
    seen = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                d = json.loads(line)
                if "error" in d:
                    continue
                key = (d["arch"], d["shape"], d["mesh"],
                       json.dumps(d.get("overrides", {}), sort_keys=True))
                seen[key] = d           # later rows win (re-runs)
    return sorted(seen.values(),
                  key=lambda d: (d["arch"], d["shape"], d["mesh"]))


def render(rows, *, only_baseline: bool = True):
    print(HEADER)
    for d in rows:
        if only_baseline and d.get("overrides"):
            continue
        peak = (d.get("peak_memory_bytes") or 0) / 2 ** 30
        print(f"{d['arch']:<24} {d['shape']:<12} {d['mesh']:<7} "
              f"{d['compute_s']:>10.4f} {d['memory_s']:>10.4f} "
              f"{d['collective_s']:>9.4f} {d['bottleneck']:<11} "
              f"{d['useful_flops_ratio']:>7.3f} {peak:>8.2f}G")


def miniconv_table(x_sizes=(84, 400), ks=(4, 16), c_in: int = 12):
    """Per-layer MiniConv roofline, derived entirely from the PassPlan."""
    from repro_torch.core.miniconv import standard_spec

    hdr = (f"{'spec':<14} {'x':>4} {'layer':>5} {'passes':>6} "
           f"{'samples':>8} {'budget%':>8} {'mflops':>8} {'kB_in':>7} "
           f"{'kB_out':>7} {'flops/B':>8}")
    print(hdr)
    for k in ks:
        spec = standard_spec(c_in=c_in, k=k)
        for x in x_sizes:
            plan = spec.plan(x)
            for lp in plan.layers:
                passes = [p for p in plan.passes if p.layer == lp.index]
                samples = max(p.samples for p in passes)
                in_b = lp.in_h * lp.in_w * lp.c_in * 4
                out_b = lp.out_h * lp.out_w * lp.c_out * 4
                w_b = lp.kernel ** 2 * lp.c_in * lp.c_out * 4
                flops = sum(p.flops for p in passes)
                # per-pass execution re-reads the input once per pass
                bytes_moved = in_b * len(passes) + out_b + w_b
                print(f"miniconv{k:<6} {x:>4} {lp.index:>5} "
                      f"{len(passes):>6} {samples:>8} "
                      f"{100 * samples / plan.budget.max_samples:>7.0f}% "
                      f"{flops / 1e6:>8.2f} {in_b / 1e3:>7.1f} "
                      f"{out_b / 1e3:>7.1f} {flops / bytes_moved:>8.1f}")
            print(f"miniconv{k:<6} {x:>4} total {plan.total_passes:>6} "
                  f"{plan.max_pass_samples:>8} "
                  f"{'':>8} {plan.flops_per_frame / 1e6:>8.2f} "
                  f"feature_bytes={plan.feature_bytes}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--glob", default="results/dryrun_*.jsonl")
    ap.add_argument("--all", action="store_true",
                    help="include override (perf-iteration) rows")
    ap.add_argument("--miniconv", action="store_true",
                    help="render the PassPlan-derived MiniConv roofline")
    args = ap.parse_args(argv)
    if args.miniconv:
        miniconv_table()
        return
    paths = sorted(glob.glob(args.glob))
    if not paths:
        print(f"no dry-run results match {args.glob}; write them with "
              f"python -m repro_torch.launch.dryrun --all --mesh both "
              f"--out <file>")
        return
    render(load(paths), only_baseline=not args.all)


__all__ = ["HEADER", "load", "main", "miniconv_table", "render"]


if __name__ == "__main__":
    main()
