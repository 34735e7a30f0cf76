"""Shared by the benchmark's CPU tests: a cell of either configuration cut
to a size a test run holds, run through the harness on the CPU."""
import copy
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import harness  # noqa: E402

torch.set_num_threads(1)

CELLS = ("mc84.envs256", "mc400.cam64")
SIDES = {"mc84.envs256": 24, "mc400.cam64": 40}


def tiny(name: str, frames: int = 4):
    """(bench, cell, config) of ``name`` at a small frame side and batch;
    the cell's limits are its own."""
    bench, cell, config = harness.load_cell(name)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    config["manifest"]["h"] = SIDES[name]
    cell["params"].update(frames_per_tick=frames, warm_ticks=2,
                          check_ticks=4, trace_ticks=4, reference_block=2)
    return bench, cell, config


def dry_run(name: str, seconds: float = 0.2, trace: int = 0,
            seed: int = 2**40 + 7):
    """Run the tiny cell on the CPU; (exit code, result line, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(name, seed, seconds, trace, device="cpu",
                     cells=tiny(name), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
