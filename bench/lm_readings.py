"""The readings that the limits of a hybrid LM cell's check are set from,
in one process on the chip:

    python3 bench/lm_readings.py --workload granite4h.pf4x2048 \
        --seeds 11,12,... --seconds 2 --control-seeds 3

For each seed it draws the cell's weights and token ids, drives the
program through the cell's own traffic for ``--seconds`` (the window's
code, at the cell's size), and judges the sampled ticks as a run does:
the sound readings.  For the first ``--control-seeds`` seeds it then puts
the control in the program's place, the reference computed with every
matrix product's operands rounded to fp8 e4m3, and judges its answers
for the same pool batches; judges the reference with those operands
rounded to bf16 instead, for one pool batch (what the stated precision
alone moves); and it plants three faults in the program's
sampled answers (the previous tick's answers served again; one code of
one payload moved by 3; every 50th token's experts, 2% of the (token,
layer) pairs, moved to others).  One JSON line a seed, then the widest sound
reading and the narrowest control reading of each number.  The
benchmark's runs do not run this.
"""
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

FAULTS = ("stale", "altered_code", "misrouted")
MISROUTED_EVERY = 50


def _routes(s: dict) -> dict:
    """The sample with its routes as one (layers, tokens, K) tensor, a copy
    of every answer."""
    r = s["routes"]
    r = torch.stack(list(r)) if isinstance(r, (list, tuple)) else r.clone()
    return {**{k: v.clone() for k, v in s.items() if k != "routes"},
            "routes": r}


def plant(fault: str, kept: list, n_experts: int) -> list:
    """``kept`` with ``fault`` planted in its answers: ``stale`` gives each
    sample the previous one's answers (reversed over the prompts where
    both decided one pool batch); ``altered_code`` moves one code of each
    payload by 3; ``misrouted`` moves each expert id of every
    ``MISROUTED_EVERY``-th token in every layer to the expert
    ``n_experts // 2`` further on, a router that picks other experts for
    2% of the pairs."""
    out = []
    for n, (idx, s) in enumerate(kept):
        s = _routes(s)
        if fault == "stale":
            prev = _routes(kept[n - 1][1])
            flip = kept[n - 1][0] == idx
            s = {k: v.flip(0) if flip and k != "routes" else v
                 for k, v in prev.items()}
        elif fault == "altered_code":
            c = s["codes"].view(-1)
            c[c.numel() // 3] = (c[c.numel() // 3].int() + 3) % 256
        elif fault == "misrouted":
            r = s["routes"][:, ::MISROUTED_EVERY]
            s["routes"][:, ::MISROUTED_EVERY] = (
                r.long() + n_experts // 2) % n_experts
        else:
            raise ValueError(fault)
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
            ctl = [(i, ref.decide(config, inputs, inputs["tokens"][i],
                                  precision="fp8",
                                  block=p.get("reference_block", 1)))
                   for i in idxs]
            line["control"] = ref.judge(config, inputs, ctl, p)
            emul = [(i, ref.decide(config, inputs, inputs["tokens"][i],
                                   precision="bf16",
                                   block=p.get("reference_block", 1)))
                    for i in idxs[:1]]
            line["bf16_emulation"] = ref.judge(config, inputs, emul, p)
            for fault in FAULTS:
                line[fault] = ref.judge(
                    config, inputs, plant(fault, rec["kept"],
                                          config["num_local_experts"]), p)
        line["seconds"] = time.perf_counter() - t0
        del inputs, rec
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
    print(json.dumps({"card": harness.power_limit()}), flush=True)
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
