"""Reproduce the reference's §Perf hillclimb: baseline + winning
configuration for each of the three optimised (arch x shape) pairs,
through the port's dry-run (``launch.dryrun.run_one``), as
``repro.launch.perf`` does.

  PYTHONPATH=src python -m repro_torch.launch.perf [--pair A|B|C|all]
"""
import argparse
import json
import math
import sys

PAIRS = {
    # (arch, shape, baseline overrides, optimised overrides)
    "A": ("qwen2-moe-a2.7b", "train_4k", {},
          {"moe_dispatch_bf16": True, "moe_pad_experts": True,
           "moe_expert_parallel": True, "param_mode": "ep_model",
           "microbatches": 4}),
    "B": ("llama4-scout-17b-a16e", "train_4k", {},
          {"moe_dispatch_bf16": True, "moe_expert_parallel": True,
           "param_mode": "ep_model", "microbatches": 8}),
    # C's winning config is the default (masked_cache_update=True);
    # the paper-faithful baseline is the DUS + head-sharded path
    "C": ("qwen3-0.6b", "decode_32k",
          {"masked_cache_update": False}, {}),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pair", choices=[*PAIRS, "all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.mesh import MULTI, init_fake_group
    init_fake_group(math.prod(MULTI[0]))

    pairs = PAIRS.items() if args.pair == "all" \
        else [(args.pair, PAIRS[args.pair])]
    for name, (arch, shape, base_over, opt_over) in pairs:
        print(f"\n=== pair {name}: {arch} x {shape} ===")
        for label, over in (("baseline", base_over), ("optimised",
                                                      opt_over)):
            print(f"--- {label} overrides={over}")
            d = run_one(arch, shape, args.mesh, overrides=over or None)
            d["pair"] = name
            d["label"] = label
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(d) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
