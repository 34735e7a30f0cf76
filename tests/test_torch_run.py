"""The port's benchmark orchestrator and roofline tables against the
reference's ``benchmarks/run.py`` and ``benchmarks/roofline_table.py`` on
the CPU.

Exact throughout: the MiniConv table is plan arithmetic, so its text
equals the reference's; ``run.main`` over sections that return the same
fixed rows in both packages prints the same report and CSV, and calls
each section with the reference's arguments plus ``device``; the dry-run
table renders the same rows from one JSONL file.
"""
import contextlib
import importlib.util
import io
import json
import sys
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.benchmarks import (break_even, decision_latency,
                                    frame_time, learning, roofline_table,
                                    scalability, sustained)
from repro_torch.benchmarks import run as t_run

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *a, **k):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*a, **k)
    return out.getvalue()


def test_miniconv_table_equals_the_reference():
    ref = _load_reference("roofline_table")
    want = _stdout(ref.miniconv_table)
    assert _stdout(roofline_table.miniconv_table) == want
    assert _stdout(roofline_table.main, ["--miniconv"]) == want
    assert want.count("\n") == 1 + 2 * 2 * 4       # 3 layers + total each


def _rows():
    return [
        {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "16x16",
         "compute_s": 1.25, "memory_s": 0.5, "collective_s": 0.125,
         "bottleneck": "compute", "useful_flops_ratio": 0.875,
         "peak_memory_bytes": 3 * 2 ** 30},
        {"arch": "mamba2-130m", "shape": "decode_32k", "mesh": "2x16",
         "compute_s": 0.01, "memory_s": 0.02, "collective_s": 0.0,
         "bottleneck": "memory", "useful_flops_ratio": 0.5,
         "peak_memory_bytes": None},
        {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "16x16",
         "overrides": {"remat": False}, "compute_s": 1.0, "memory_s": 0.75,
         "collective_s": 0.25, "bottleneck": "memory",
         "useful_flops_ratio": 0.75, "peak_memory_bytes": 2 ** 31},
        {"arch": "qwen3-0.6b", "shape": "prefill_32k", "mesh": "16x16",
         "error": "compile failed"},
        # a re-run of the first row: the later wins
        {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "16x16",
         "compute_s": 1.5, "memory_s": 0.5, "collective_s": 0.125,
         "bottleneck": "compute", "useful_flops_ratio": 0.625,
         "peak_memory_bytes": 2 ** 30},
    ]


@pytest.mark.parametrize("extra", [[], ["--all"]])
def test_dryrun_table_renders_the_reference_rows(tmp_path, extra):
    path = tmp_path / "dryrun_a.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _rows()))
    ref = _load_reference("roofline_table")
    argv = ["--glob", str(tmp_path / "dryrun_*.jsonl")] + extra
    got = _stdout(roofline_table.main, argv)
    assert got == _stdout(ref.main, argv)
    assert got.splitlines()[0] == roofline_table.HEADER
    assert len(got.splitlines()) == 1 + 2 + bool(extra)
    assert roofline_table.load([path]) == ref.load([path])


def test_dryrun_table_without_results_names_the_roadmap_item(tmp_path):
    out = _stdout(roofline_table.main, ["--glob", str(tmp_path / "*.jsonl")])
    assert "no dry-run results match" in out
    assert "python -m repro_torch.launch.dryrun" in out
    assert "repro.launch" not in out and "item 2.5" not in out


# ---------------------------------------------------------------------------
# run.main on fixed section results
# ---------------------------------------------------------------------------

def _sections(calls):
    """Stand-ins for every section, returning the same rows in both
    packages and recording each call's arguments."""

    def rec(name, value):
        def fn(*a, **k):
            calls.append((name, a, k))
            return value
        return fn

    learn = [types.SimpleNamespace(task="pendulum", encoder=e, final=f)
             for e, f in (("miniconv4", -812.34567), ("full_cnn", -1203.5))]
    compare = ([{"x": 64, "xla_ms": 0.51234, "fused_ms": 0.031,
                 "per_pass_ms": 0.25},
                {"x": 128, "xla_ms": 0.9, "fused_ms": 0.05,
                 "per_pass_ms": 0.41235}], True)
    sus = {"fused": {"mean_ms": 0.21, "drift_pct": -1.5},
           "xla": {"mean_ms": 0.73, "drift_pct": 0.25}}
    lat = [{"mbps": 10, "server_only_ms": 72.16775, "split_ms": 4.949},
           {"mbps": 25.0, "server_only_ms": 30.5, "split_ms": 4.61}]
    scal = ({"server_only": 12, "split_fifo": 128, "split_batched": 128},
            {8: (5.25, 5.0), 16: (9.75, 6.125)})
    be = [{"config": "paper", "pred": 50.4, "sim": 50.12345},
          {"config": "X84n3K4", "pred": 48.0, "sim": 47.5}]

    def roof_main(argv):
        calls.append(("roofline_table.main", (argv,), {}))
        print("no dry-run results (stand-in)")

    def roof_mc():
        calls.append(("roofline_table.miniconv_table", (), {}))
        print("miniconv table (stand-in)")

    return {"learning": {"run": rec("learning.run", learn)},
            "frame_time": {"run_compare": rec("frame_time.run_compare",
                                              compare)},
            "sustained": {"run": rec("sustained.run", sus)},
            "decision_latency": {"run": rec("decision_latency.run", lat)},
            "scalability": {"run": rec("scalability.run", scal)},
            "break_even": {"run": rec("break_even.run", be)},
            "roofline_table": {"main": roof_main,
                               "miniconv_table": roof_mc}}


def _without_clock(out):
    lines = out.splitlines()
    assert lines[-1].startswith("total bench time ")
    return lines[:-1]


def test_run_main_prints_the_reference_report(monkeypatch):
    ref_calls, port_calls = [], []
    pkg = types.ModuleType("benchmarks")
    for name, attrs in _sections(ref_calls).items():
        mod = types.ModuleType(f"benchmarks.{name}")
        for attr, fn in attrs.items():
            setattr(mod, attr, fn)
        setattr(pkg, name, mod)
        monkeypatch.setitem(sys.modules, f"benchmarks.{name}", mod)
    monkeypatch.setitem(sys.modules, "benchmarks", pkg)
    ref = _load_reference("run")
    want = _without_clock(_stdout(ref.main))

    mods = {"learning": learning, "frame_time": frame_time,
            "sustained": sustained, "decision_latency": decision_latency,
            "scalability": scalability, "break_even": break_even,
            "roofline_table": roofline_table}
    for name, attrs in _sections(port_calls).items():
        for attr, fn in attrs.items():
            monkeypatch.setattr(mods[name], attr, fn)
    got = _without_clock(_stdout(t_run.main, ["--device", "cpu"]))

    assert got == want
    csv = got[got.index("name,metric,value"):]
    assert csv[1] == "learning/pendulum/miniconv4,final_return,-812.3457"
    assert "latency/10mbps,server_only_ms,72.1677" in csv
    assert "scalability/n16,batched_p95_ms,6.1250" in csv
    assert len(csv) == 1 + 2 + 6 + 4 + 4 + 3 + 4 + 4 + 1
    # the reference's arguments, and the device wherever a section takes one
    assert [c[0] for c in port_calls] == [c[0] for c in ref_calls]
    for (name, a, k), (_, ra, rk) in zip(port_calls, ref_calls):
        assert a == ra
        if name in ("break_even.run", "roofline_table.main",
                    "roofline_table.miniconv_table"):
            assert k == rk
        else:
            assert k == dict(rk, device="cpu")


def test_run_main_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _stdout(t_run.main, [])
