"""One run of one benchmark cell.

``run`` finds the cell by name (``BENCHMARK.json``, then
``bench/workloads/<cell>.json`` and the configuration file it names),
builds the system under test from ``bench/systems/<family>.py``, makes the
weights and frames from the seed with ``bench/reference/<family>.py``,
warms the cell's one shape, and drives the window with
``bench/traffic/<kind>.py``.  With ``trace=1`` the window is followed by a
profiled stretch.  Once the window has closed it reads the device's peak
memory, frees the program's state, checks that no module of JAX or of the
JAX package is loaded, compares the sampled answers with the reference
(``judge``), reads the cell's metrics with ``bench/metrics/<metric>.py``
and prints the result as one JSON line, last on standard output.

A later cell, configuration, traffic kind or metric is a new file beside
these, found by the name ``BENCHMARK.json`` gives it.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import trace as trace_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the cell's file, its configuration's file)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    cell = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    for k in ("config", "traffic", "chips"):
        if cell[k] != entry[k]:
            raise SystemExit(f"{name}: {k} is {entry[k]!r} in BENCHMARK.json"
                             f" but {cell[k]!r} in its file")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    return bench, cell, config


def metric_entries(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str):
    """``bench/metrics/<name>.py``, loaded by its path."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of the loaded modules (or of ``names``) that are
    JAX's or the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def modules(config: dict, cell: dict):
    """The cell's system, reference and traffic modules, found by the
    configuration's family and the cell's traffic kind; sets one CPU
    thread.  The family's system validates and sets the precision its
    configuration states."""
    torch.set_num_threads(1)
    family = config["family"]
    return (importlib.import_module(f"bench.systems.{family}"),
            importlib.import_module(f"bench.reference.{family}"),
            importlib.import_module(f"bench.traffic.{cell['kind']}"))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def _own_program() -> str:
    """Empty when ``repro_torch`` is this checkout's, else why not."""
    import repro_torch
    where = Path(repro_torch.__file__).resolve().parents[1]
    if where != ROOT / "src":
        return f"repro_torch loaded from {where}, not {ROOT / 'src'}"
    return ""


def run(name: str, seed: int, seconds: float, trace: int, *,
        device: str = "cuda", cells=None, t0=None, age0: float = 0.0,
        out=None, err=None) -> int:
    """One run; returns the exit code.  ``cells`` replaces
    :func:`load_cell`'s (bench, cell, config), as the tests do for tiny
    sizes.  On the CPU (``device="cpu"``) the run is a dry run: it drives
    the program's plain versions and decides ``correct`` for real, but
    reports every metric as not measured."""
    out, err = out or sys.stdout, err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    bench, cell, config = cells or load_cell(name)
    dev = torch.device(device)
    dry = dev.type != "cuda"
    if not dry:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{name}: needs {cell['chips']} CUDA device(s); "
                  f"is_available={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=err)
            return 2
        why = _own_program()
        if why:
            print(f"{name}: {why}", file=err)
            return 2
    system_mod, ref, traffic = modules(config, cell)
    params = cell["params"]

    # set-up, with the host clock's reading after each part
    phases = {"imports": age0 + time.perf_counter() - t0}
    system = system_mod.System(config, cell, dev)
    phases["program"] = age0 + time.perf_counter() - t0
    inputs = ref.make_inputs(config, params, seed, dev)
    system.bind(inputs)
    phases["inputs"] = age0 + time.perf_counter() - t0
    traffic.warm(system, params)
    gc.collect()
    gc.freeze()
    setup_s = age0 + time.perf_counter() - t0
    rec = traffic.run(system, params, seconds, seed)
    if trace:
        rec["trace"] = trace_mod.reduce(
            traffic.profile(system, params, dev.type)["events"])
    counters = system.counters()
    build_log = system.build_log
    peak = torch.cuda.max_memory_allocated(dev) if not dry else 0
    kept = rec.pop("kept")
    system.close()
    del system
    gc.unfreeze()
    gc.collect()
    bad = forbidden_modules()
    if bad and not dry:     # a dry run prints no result the driver reads
        print(f"{name}: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=err)
        return 3

    readings = ref.judge(config, inputs, kept, params)
    checks = {k: {"value": readings.get(k), "limit": lim}
              for k, lim in cell["limits"].items()}
    correct = bool(checks) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    kind = torch.cuda.get_device_name(dev) if not dry else "cpu"
    rec.update(setup_s=setup_s, config=config, cell=cell, device_kind=kind)
    metrics = {}
    for m in metric_entries(bench, name,
                            "per_layer" if trace else "end_to_end"):
        if dry:
            metrics[m["name"]] = {"value": None, "unit": m["unit"],
                                  "note": "not measured: CPU dry run"}
            continue
        reader = load_reader(m["name"])
        if reader.UNIT != m["unit"]:
            raise SystemExit(f"metric {m['name']}: unit {reader.UNIT!r} in "
                             f"its reader, {m['unit']!r} in BENCHMARK.json")
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "cpu" if dry else "gpu", "kind": kind,
                   "count": 0 if dry else cell["chips"],
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec["units"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        t = rec["trace"]
        device_info["busy_s"] = t["busy_us"] / 1e6
        device_info["window_s"] = t["window_us"] / 1e6
        if t["ops"]:
            result["breakdown"] = trace_mod.breakdown(t)
    result["checks"] = checks

    card = "" if dry else power_limit()
    print(json.dumps({"workload": name, "seed": seed, "card": card,
                      "ticks": rec["ticks"], "window_s": rec["window_s"],
                      "setup_s": setup_s, "setup_at": phases,
                      **counters}), file=out)
    for line in build_log:
        print(f"{name}: {line}", file=err)
    print(f"{name}: card {card or kind}; " + ", ".join(
        f"{k} {v}" for k, v in counters.items()), file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None, t0=None, age0: float = 0.0) -> int:
    ap = argparse.ArgumentParser(
        description="Run one benchmark cell and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    return run(a.workload, a.seed, a.seconds, a.trace, t0=t0, age0=age0)


__all__ = ["forbidden_modules", "load_cell", "load_reader", "main",
           "metric_entries", "modules", "run"]
