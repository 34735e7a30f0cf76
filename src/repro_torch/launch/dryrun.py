"""Multi-pod dry-run: trace every (architecture x input-shape) step on the
production meshes, print its cost and memory, and emit the roofline rows
(``benchmarks.roofline_table`` reads them), as ``repro.launch.dryrun``
does.

Where the reference forces 512 XLA host devices and lowers and compiles
each step, the port makes a fake process group of 512 ranks
(``launch.mesh``) and runs each step once over ``meta`` DTensors under
the cost counter (``launch.steps.trace_step``: at one repeated block and
at two, carried to the model's depth, as the reference's HLO walk
multiplies a loop body by its trip count): it needs no card and
allocates nothing, on any host.  The fake group cannot share a
process with a real one, so run it in a process of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun.jsonl
"""
import argparse
import json
import math
import sys
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import MULTI, init_fake_group, \
    make_production_mesh
from repro_torch.launch.roofline import HEADER, analyse, fmt_row
from repro_torch.launch.steps import _apply_overrides, trace_step


def run_one(arch: str, shape_id: str, mesh_name: str, *,
            overrides=None, verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    chips = math.prod(mesh.shape)
    kind = SHAPES[shape_id].kind
    traced = trace_step(arch, shape_id, mesh, overrides=overrides)
    c = traced.counter
    if verbose:
        print(f"[{kind}:{arch}:{shape_id} mesh={mesh_name}] trace "
              f"{traced.trace_s:.1f}s ({c.ops} ops a chip)")
        print(f"  memory: peak {c.peak_bytes / 2**30:.3f} GiB of live "
              f"local storage a chip")
    cfg, _ = _apply_overrides(get_config(arch), overrides)
    r = analyse(traced, arch=arch, shape_cfg=SHAPES[shape_id],
                mesh_name=mesh_name, chips=chips, cfg=cfg)
    if verbose:
        print(f"  cost: flops/chip={r.flops_per_chip:.3e} "
              f"bytes/chip={r.bytes_per_chip:.3e}")
        coll = {k: v for k, v in r.coll_breakdown.items() if v}
        print(f"  collectives/chip: {coll}")
        print("  " + fmt_row(r))
    d = r.to_dict()
    d["trace_s"] = traced.trace_s
    # DTensor picks the layouts the counts follow, and its choices change
    # between torch releases
    d["torch"] = torch.__version__
    if overrides:
        d["overrides"] = {k: str(v) for k, v in overrides.items()}
    return d


def parse_overrides(items) -> dict:
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if v in ("true", "false"):
            overrides[k] = v == "true"
        else:
            try:
                overrides[k] = json.loads(v)
            except json.JSONDecodeError:
                overrides[k] = v          # plain string (e.g. tp_only)
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--override", action="append", default=[],
                    help="perf override key=value (repeatable)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.override)
    init_fake_group(math.prod(MULTI[0]))

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    print(HEADER)
    failures = []
    for arch in archs:
        for shape_id in shapes:
            for mesh_name in meshes:
                try:
                    d = run_one(arch, shape_id, mesh_name,
                                overrides=overrides or None)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(d) + "\n")
                except Exception as e:  # repro: allow(broad-except) -- a failure here IS the sharding bug under test; record the cell and keep sweeping
                    traceback.print_exc()
                    failures.append((arch, shape_id, mesh_name, repr(e)))
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps({
                                "arch": arch, "shape": shape_id,
                                "mesh": mesh_name, "error": repr(e)}) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall dry-runs traced OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
