"""The readings that the limits of an MLA LM cell's check are set from, in
one process on the chip:

    python3 bench/mla_readings.py --workload moonlight.pf2x8192 \
        --seeds 11,12,... --seconds 2 --control-seeds 3

As ``bench/lm_readings.py`` does for a hybrid LM cell: for each seed it
draws the cell's weights and token ids, drives the program through the
cell's own traffic for ``--seconds`` and judges the sampled ticks as a run
does (the sound readings).  For the first ``--control-seeds`` seeds it
then judges the control (the reference with every matrix product's
operands rounded to fp8 e4m3 in the program's place), the reference with
bf16 operands and residual stream for one pool batch, the three faults
``lm_readings.plant`` plants in the sampled answers (stale answers, a code
moved by 3, every 50th token's experts moved), and two faults planted in
the program's router, each driven through the traffic for ``--seconds``:
``no_bias`` (the choice made on the sigmoid scores alone, the correction
bias ignored) and ``no_scale`` (the gates not multiplied by
``routed_scaling_factor``).  One JSON line a seed, then the widest sound
reading and the narrowest control reading of each number.  The
benchmark's runs do not run this.
"""
import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from bench.lm_readings import FAULTS, plant  # noqa: E402

ROUTER_FAULTS = ("no_bias", "no_scale")


@contextlib.contextmanager
def router_fault(name: str):
    """The program's dropless router with ``name`` planted: ``no_bias``
    chooses on the sigmoid scores alone; ``no_scale`` leaves out the
    routed scaling factor."""
    import torch
    from repro_torch.nn import moe
    route = moe._route

    def faulty(params, cfg, logits):
        if name == "no_bias":
            zero = torch.zeros_like(params["e_score_correction_bias"])
            return route({**params, "e_score_correction_bias": zero}, cfg,
                         logits)
        if name == "no_scale":
            idx, gates = route(params, cfg, logits)
            return idx, gates / cfg.routed_scaling
        raise ValueError(name)
    moe._route = faulty
    try:
        yield
    finally:
        moe._route = route


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
        # the last seed's weights go before the next seed's are drawn: two
        # copies of a 32 GB model leave the reference no room on one card
        system.edge_params = system.server_params = system.pool = None
        system.payload = system.hidden = system.routes = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        inputs = ref.make_inputs(config, p, seed, dev)
        system.bind(inputs)
        traffic.warm(system, p)
        rec = traffic.run(system, p, seconds, seed)
        line = {"seed": seed, "ticks": rec["ticks"],
                "sound": ref.judge(config, inputs, rec["kept"], p)}
        if n < control_seeds:
            idxs = sorted({i for i, _ in rec["kept"]})
            block = p.get("reference_block", 1)
            ctl = [(i, ref.decide(config, inputs, inputs["tokens"][i],
                                  precision="fp8", block=block))
                   for i in idxs]
            line["control"] = ref.judge(config, inputs, ctl, p)
            emul = [(i, ref.decide(config, inputs, inputs["tokens"][i],
                                   precision="bf16", block=block))
                    for i in idxs[:1]]
            line["bf16_emulation"] = ref.judge(config, inputs, emul, p)
            for fault in FAULTS:
                line[fault] = ref.judge(
                    config, inputs, plant(fault, rec["kept"],
                                          config["n_routed_experts"]), p)
            for fault in ROUTER_FAULTS:
                with router_fault(fault):
                    bad = traffic.run(system, p, seconds, seed)
                line[fault] = ref.judge(config, inputs, bad["kept"], p)
                del bad
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
