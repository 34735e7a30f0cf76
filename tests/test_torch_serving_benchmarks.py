"""The port's serving benchmarks and the deployment example end to end on
the CPU, against the reference where the reference is exact.

``benchmarks.realfleet.calibrate`` spawns a 2-worker fleet of the small
calibration deployment with ``device="cpu"`` and runs every router for
0.5 s: its rows carry the reference's keys and pass the reference's smoke
gate as well as the port's.  ``decision_latency --real-fleet --device cpu``
at 36x36 (the smallest input the NatureCNN baseline takes) reports the
real fleet beside the loopback sim.  ``scenarios.sweep`` is pure
simulation: its rows equal the reference's with ``==`` on every field.
``sustained.run`` and the deploy example (which ends with a real fleet)
run with ``device="cpu"``.  Three fleets are spawned in this file.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro_torch import deploy as t_deploy
from repro_torch.benchmarks import (decision_latency, realfleet, scalability,
                                    scenarios, sustained)
from repro_torch.examples import deploy_policy
from repro_torch.serving.fleet import router_names
from repro_torch.serving.scenario import scenario_names

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# the keys of a row of the reference's calibrate (benchmarks/realfleet.py)
ROW_KEYS = {"n_servers", "router", "n_clients", "rate_hz", "duration_s",
            "shaping", "n_requests", "n_failures", "predicted_p95_ms",
            "measured_p95_ms", "measured_p50_ms", "max_served_batch",
            "leaked_workers"}


def _reference_benchmark(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_calibrate_rows_and_smoke_gate_on_cpu(tmp_path):
    ref = _reference_benchmark("realfleet")
    cfg = realfleet.small_config()
    assert cfg.to_dict() == dict(ref.small_config().to_dict())
    rows = realfleet.calibrate(cfg, n_servers_list=(2,), duration_s=0.5,
                               device="cpu")
    assert [r["router"] for r in rows] == list(router_names())
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["n_servers"] == 2 and r["shaping"] is None
        assert r["n_requests"] == 4 * 20 * 0.5 and r["n_failures"] == 0
        assert r["leaked_workers"] == 0
        assert 1 <= r["max_served_batch"] <= cfg.max_batch
        assert 0.0 < r["measured_p50_ms"] <= r["measured_p95_ms"]
        assert np.isfinite(r["predicted_p95_ms"])
    assert realfleet.smoke_gate(rows)
    assert ref.smoke_gate(rows)
    broken = [dict(rows[0], n_failures=1)]
    assert not realfleet.smoke_gate(broken) and not ref.smoke_gate(broken)

    path = str(tmp_path / "realfleet.json")
    doc = realfleet.write_artifact(rows, cfg, path=path, device="cpu")
    assert (doc["mode"], doc["transport"]) == ("eager", "socket")
    assert realfleet.check_against(path, artifact=path) == []
    sim = tmp_path / "sim.json"
    sim.write_text(json.dumps(dict(doc, transport="sim")))
    with pytest.raises(ValueError, match="transport"):
        realfleet.check_against(str(sim), artifact=path)
    assert realfleet.ARTIFACT.endswith("build/realfleet.json")


def test_decision_latency_real_fleet_on_cpu(tmp_path, capsys):
    manifest = tmp_path / "m.json"
    manifest.write_text(t_deploy.DeploymentConfig.standard(
        k=4, c_in=12, h=36, max_batch=8).to_json())
    decision_latency.main(["--device", "cpu", "--manifest", str(manifest),
                           "--decisions", "10", "--bandwidths", "10",
                           "--clients", "4", "--real-fleet"])
    out = capsys.readouterr().out
    assert "N=4 @ 10Hz: p95 FIFO" in out
    line = next(l for l in out.splitlines() if "REAL fleet" in l)
    assert "(1 servers, round_robin, localhost, cpu)" in line
    assert "(80 reqs, 0 failed, 0 leaked)" in line     # 4 x 10 Hz x 2 s


def test_scalability_real_fleet_calls_the_calibration(tmp_path, monkeypatch,
                                                      capsys):
    """``scalability --real-fleet`` hands the manifest and the device to
    ``benchmarks.realfleet`` (its fleets are spawned in the test above)."""
    calls = {}

    def calibrate(cfg, *, n_servers_list, device):
        calls["calibrate"] = (cfg, n_servers_list, device)
        return []

    def write_artifact(rows, cfg, *, device):
        calls["write"] = (rows, device)

    monkeypatch.setattr(realfleet, "calibrate", calibrate)
    monkeypatch.setattr(realfleet, "write_artifact", write_artifact)
    cfg = t_deploy.DeploymentConfig.standard(k=4, c_in=12, h=36)
    manifest = tmp_path / "m.json"
    manifest.write_text(cfg.to_json())
    scalability.main(["--smoke", "--no-fleet", "--device", "cpu",
                      "--manifest", str(manifest), "--real-fleet"])
    assert calls["calibrate"] == (cfg, (1, 2), "cpu")
    assert calls["write"] == ([], "cpu")
    assert "real-fleet calibration" in capsys.readouterr().out


def test_scenarios_sweep_equals_reference(tmp_path):
    ref = _reference_benchmark("scenarios")
    names = scenario_names()
    got = scenarios.sweep(names)
    want = ref.sweep(names)
    assert len(got) == len(want) > len(names)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], (g["scenario"], g["adaptation"], k)
    assert scenarios.smoke_gate(got) and ref.smoke_gate(want)
    assert scenarios.adaptations_for(scenarios.get_scenario(
        "trace_dropout")) == ref.adaptations_for(
            ref.get_scenario("trace_dropout"))
    path = str(tmp_path / "scenarios.json")
    doc = scenarios.write_artifact(got, names,
                                   payload_bytes=scenarios.PAYLOAD_BYTES,
                                   path=path)
    assert doc["transport"] == "sim" and set(doc["scenarios"]) == set(names)
    scenarios.check_against(path, artifact=path)
    other = tmp_path / "other.json"
    other.write_text(json.dumps(dict(doc, scenarios={})))
    with pytest.raises(ValueError, match="cross-scenario"):
        scenarios.check_against(str(other), artifact=path)
    assert scenarios.ARTIFACT.endswith("build/scenarios.json")


def test_sustained_on_cpu(tmp_path, capsys):
    out = sustained.run(device="cpu", n_frames=20, x_size=24)
    assert set(out) == {"fused", "xla"}
    for name, row in out.items():
        assert row["backend"] == name and row["mode"] == "eager"
        assert row["n_frames"] == 20
        assert 0.0 < row["mean_ms"] <= row["p99_ms"]
        assert np.isfinite([row["drift_pct"], row["cv_pct"]]).all()
    manifest = tmp_path / "m.json"
    manifest.write_text(t_deploy.DeploymentConfig.standard(
        k=4, c_in=4, h=24, backend="grouped").to_json())
    out = sustained.run(device="cpu", n_frames=8, manifest=str(manifest))
    assert list(out) == ["grouped"] and out["grouped"]["n_frames"] == 8
    assert "8 frames on cpu" in capsys.readouterr().out


def test_deploy_example_on_cpu(capsys):
    res = deploy_policy.main(["--device", "cpu"])
    assert res["bitwise"] and res["leaked"] == []
    assert res["max_abs_err"] < 0.05
    out = capsys.readouterr().out
    assert "one wave of K4's resident blocks on the card: B <= 68" in out
    assert "real fleet: 1 worker process(es) on cpu served 3 requests" in out
