"""The readings that the limits of a cell's check are set from, in one
process on the chip:

    python3 bench/readings.py --workload <cell> --seeds 11,12,... \
        --seconds 2 --control-seeds 3

For each seed it draws the cell's weights and frames, drives the program
through the cell's own traffic for ``--seconds`` (the window's code, at
the cell's size), and judges the sampled ticks as a run does: the sound
readings.  For the first ``--control-seeds`` seeds it then puts the
control in the program's place, the reference computed with every
product's operands in TF32, and judges its answers for the same pool
batches; and it plants three faults in the program's sampled answers
(the previous pool batch's answers served again; the second half of each
tick's rows replaced by the first half's; one code of one payload moved
by 3).  One JSON line a seed, then the widest sound reading and the
narrowest control reading of each number.  The benchmark's runs do not
run this.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]


def plant(fault: str, kept: list) -> list:
    """``kept`` with ``fault`` planted in its answers."""
    out = []
    for n, (idx, s) in enumerate(kept):
        s = {k: v.clone() for k, v in s.items()}
        if fault == "stale":
            prev = kept[n - 1][1]
            if kept[n - 1][0] == idx:       # same batch: still stale
                prev = {k: v.flip(0) for k, v in prev.items()}
            s = {k: v.clone() for k, v in prev.items()}
        elif fault == "half_batch":
            h = s["codes"].shape[0] // 2
            for k in s:
                s[k][h:2 * h] = s[k][:h]
        elif fault == "altered_code":
            c = s["codes"].view(-1)
            c[c.numel() // 3] = (c[c.numel() // 3].int() + 3) % 256
        out.append((idx, s))
    return out


def readings(cell: dict, config: dict, seeds, seconds: float,
             control_seeds: int, device):
    """Yield one dict of readings a seed (see the module's docstring)."""
    import torch

    from bench import harness
    sysmod, ref, traffic = harness.modules(config, cell)
    p = cell["params"]
    dev = torch.device(device)
    system = sysmod.System(config, cell, dev)
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        inputs = ref.make_inputs(config, p, seed, dev)
        system.bind(inputs)
        traffic.warm(system, p)
        rec = traffic.run(system, p, seconds, seed)
        line = {"seed": seed, "ticks": rec["ticks"],
                "sound": ref.judge(config, inputs, rec["kept"], p)}
        if n < control_seeds:
            idxs = sorted({i for i, _ in rec["kept"]})
            ctl = [(i, ref.decide(config, inputs, inputs["frames"][i],
                                  precision="tf32",
                                  block=p.get("reference_block", 8)))
                   for i in idxs]
            line["control"] = ref.judge(config, inputs, ctl, p)
            for fault in ("stale", "half_batch", "altered_code"):
                line[fault] = ref.judge(config, inputs,
                                        plant(fault, rec["kept"]), p)
        line["seconds"] = time.perf_counter() - t0
        yield line
    system.close()


def main(argv=None) -> int:
    import argparse
    import json

    from bench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args(argv)
    _, cell, config = harness.load_cell(a.workload)
    sound, control = {}, {}
    for line in readings(cell, config, [int(s) for s in a.seeds.split(",")],
                         a.seconds, a.control_seeds, "cuda"):
        for k, v in line["sound"].items():
            sound[k] = max(sound.get(k, 0.0), v)
        for k, v in line.get("control", {}).items():
            control[k] = min(control.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": a.workload, "widest_sound": sound,
                      "narrowest_control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
