"""The port's training benchmarks, ``repro_torch.benchmarks.population``
and ``repro_torch.benchmarks.learning``, on the CPU: each smoke gate
accepts a sound document and rejects each fault it names, and each
benchmark runs end to end at a tiny size through its command line,
writing its JSON where it is told.  Throughput numbers from this host
are never gated here: the vmap lanes' 3x gate runs on the card
(chip_smoke's phase 15)."""
import copy
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.benchmarks import learning, population
from repro_torch.rl.ddpg import DDPGConfig
from repro_torch.rl.ppo import PPOConfig
from repro_torch.rl.sac import SACConfig

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

CPU = "cpu"


def _population_doc():
    rows = [{"P": P, "lane_mode": mode, "aggregate_steps_per_sec": 100.0,
             "speedup_vs_sequential": sp}
            for mode, sps in (("exact", (1.0, 1.1, 1.2)),
                              ("vmap", (1.0, 2.5, 4.0)))
            for P, sp in zip((1, 4, 16), sps)]
    return {"mode": "cuda", "rows": rows,
            "member0_parity": {"bitwise": True, "params_bitwise": True,
                               "returns_bitwise": True},
            "eval_protocol": {"bitwise_replay": True,
                              "final_100_mean": -120.5}}


def _vmap_row(doc, P):
    return next(r for r in doc["rows"]
                if r["lane_mode"] == "vmap" and r["P"] == P)


POPULATION_FAULTS = {
    "member 0": lambda d: d["member0_parity"].update(bitwise=False),
    "not deterministic": lambda d: d["eval_protocol"].update(
        bitwise_replay=False),
    "non-finite eval": lambda d: d["eval_protocol"].update(
        final_100_mean=float("nan")),
    "zero agg": lambda d: d["rows"][0].update(aggregate_steps_per_sec=0.0),
    "slower than sequential": lambda d: _vmap_row(d, 4).update(
        speedup_vs_sequential=0.9),
    "only 2.90x": lambda d: _vmap_row(d, 16).update(
        speedup_vs_sequential=2.9),
    "no vmap lanes": lambda d: d.update(rows=[r for r in d["rows"]
                                              if r["lane_mode"] == "exact"]),
}


def test_population_smoke_gate_accepts_a_sound_document():
    doc = _population_doc()
    # the exact lanes carry no speedup gate
    doc["rows"][2]["speedup_vs_sequential"] = 0.5
    population.check_smoke(doc)


@pytest.mark.parametrize("fault", list(POPULATION_FAULTS))
def test_population_smoke_gate_rejects(fault):
    doc = copy.deepcopy(_population_doc())
    POPULATION_FAULTS[fault](doc)
    with pytest.raises(AssertionError, match=fault):
        population.check_smoke(doc)


def _learning_doc():
    cond = {"task": "pendulum", "encoder": "miniconv4", "best": -100.0,
            "final": -150.0, "mean": -140.0, "episodes": 3,
            "episodes_completed": 2, "steps_per_sec": 80.0,
            "compile_s": 0.5, "steady_steps_per_sec": 90.0}
    return {"conditions": [cond, dict(cond, task="walker",
                                      steady_steps_per_sec=None)],
            "offpolicy_throughput": {"engine_steps_per_sec": 500.0,
                                     "legacy_steps_per_sec": 50.0}}


LEARNING_FAULTS = {
    "non-finite final": lambda d: d["conditions"][0].update(
        final=float("nan")),
    "non-finite best": lambda d: d["conditions"][1].update(
        best=float("inf")),
    "no episodes": lambda d: d["conditions"][0].update(episodes=0),
    "0 completed episodes": lambda d: d["conditions"][1].update(
        episodes_completed=0),
    "zero throughput measured": lambda d: d["offpolicy_throughput"].update(
        legacy_steps_per_sec=0.0),
    "pendulum/miniconv4: zero throughput": lambda d: d["conditions"][0]
    .update(steps_per_sec=0.0),
    "bad compile_s": lambda d: d["conditions"][0].update(compile_s=-1.0),
    "bad steady": lambda d: d["conditions"][0].update(
        steady_steps_per_sec=0.0),
}


def test_learning_smoke_gate_accepts_a_sound_document():
    learning.check_smoke(_learning_doc())


@pytest.mark.parametrize("fault", list(LEARNING_FAULTS))
def test_learning_smoke_gate_rejects(fault):
    doc = copy.deepcopy(_learning_doc())
    LEARNING_FAULTS[fault](doc)
    with pytest.raises(AssertionError, match=fault):
        learning.check_smoke(doc)


def test_population_benchmark_end_to_end(tmp_path, capsys):
    """The command line at a tiny size: the grid over both lane modes,
    the member-0 parity and the eval protocol, its JSON, and --against
    (itself: the same mode; a document of another mode: refused)."""
    out = tmp_path / "population.json"
    doc = population.main(["--device", CPU, "--steps", "8", "--pops", "1,2",
                           "--json", str(out)])
    saved = json.loads(out.read_text())
    assert saved["benchmark"] == "population" and saved["mode"] == "eager"
    assert [(r["lane_mode"], r["P"]) for r in saved["rows"]] == [
        ("exact", 1), ("exact", 2), ("vmap", 1), ("vmap", 2)]
    for r in saved["rows"]:
        assert r["population_steps"] == r["P"] * 8
        assert r["aggregate_steps_per_sec"] > 0
        assert r["speedup_vs_sequential"] == pytest.approx(
            r["steady_aggregate_steps_per_sec"]
            / r["steady_sequential_steps_per_sec"])
        assert r["first_pass_speedup_vs_sequential"] > 0
        assert r["regime"] == "collection"
    assert saved["member0_parity"]["bitwise"]
    assert saved["eval_protocol"]["bitwise_replay"]
    assert np.isfinite(saved["eval_protocol"]["final_100_mean"])
    assert doc["lane_modes"] == ["exact", "vmap"]
    population.compare_against(doc, str(out))
    assert "vmap P=2: speedup" in capsys.readouterr().out
    other = tmp_path / "other.json"
    other.write_text(json.dumps(dict(saved, mode="cuda")))
    with pytest.raises(SystemExit) as e:
        population.compare_against(doc, str(other))
    assert e.value.code == 2


def test_learning_benchmark_end_to_end(tmp_path):
    """``learning.run`` over the three pairings at tiny configs, written
    to JSON; the command line with the default configs; the engine
    against the legacy per-step loop."""
    cfgs = {"ppo": PPOConfig(n_envs=2, n_steps=4, n_epochs=1,
                             n_minibatches=2),
            "sac": SACConfig(n_envs=2, learning_starts=8, batch_size=8,
                             buffer_size=64),
            "ddpg": DDPGConfig(n_envs=2, learning_starts=8, batch_size=8,
                               buffer_size=64)}
    rows = learning.run(total_steps=16, encoders=("miniconv4",), cfgs=cfgs,
                        device=CPU)
    assert [(r.task, r.algo) for r in rows] == [
        ("walker", "ppo"), ("hopper", "sac"), ("pendulum", "ddpg")]
    out = tmp_path / "learning.json"
    doc = learning.write_bench(rows, total_steps=16, path=str(out),
                               device=CPU)
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(doc))
    assert saved["benchmark"] == "learning" and saved["mode"] == "eager"
    assert all(c["steps_per_sec"] > 0 and c["episodes"] >= 2
               for c in saved["conditions"])
    # the command line (default configs: all warmup at this budget)
    out2 = tmp_path / "cli.json"
    learning.main(["--device", CPU, "--steps", "8", "--tasks", "pendulum",
                   "--encoders", "miniconv4,full_cnn", "--json", str(out2)])
    assert [c["encoder"] for c in json.loads(out2.read_text())
            ["conditions"]] == ["miniconv4", "full_cnn"]
    row = learning.compare_offpolicy(total_steps=8, n_envs=2, reps=1,
                                     device=CPU)
    assert row["engine_steps_per_sec"] > 0 and row["legacy_steps_per_sec"] > 0
    assert row["regime"] == "collection" and row["speedup"] > 0
    with pytest.raises(ValueError, match="OFF-policy"):
        learning.measure_legacy_throughput("walker", "miniconv4",
                                           total_steps=4, device=CPU)
