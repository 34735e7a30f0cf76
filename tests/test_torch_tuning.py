"""The port's autotuner against the reference's, and the port's
``frame_time`` benchmark.

The search grid, the serving-cost arithmetic and the ``TunedPlan`` schema
are the reference's and are compared exactly.  The cost model is the
port's own (its constants come from measurements on the card), so it is
checked for the properties pruning relies on.  ``tune`` is checked for
determinism under a stubbed measurement and under a stubbed timer; on the
CPU it stamps ``mode="eager"``.
"""
import dataclasses
import hashlib
import itertools
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

from repro.core import tuning as j_tuning
from repro.deploy import DeploymentConfig as JConfig
from repro_torch import deploy as t_deploy
from repro_torch.benchmarks import frame_time
from repro_torch.core import tuning as t_tuning
from repro_torch.core.backends import backend_names
from repro_torch.core.miniconv import LayerSpec, MiniConvSpec
from repro_torch.core.tuning import Candidate, TunedPlan

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _pair(h, max_batch, c_in=12, **kw):
    return (JConfig.standard(k=4, c_in=c_in, h=h, max_batch=max_batch, **kw),
            t_deploy.DeploymentConfig.standard(k=4, c_in=c_in, h=h,
                                               max_batch=max_batch, **kw))


def _as_tuples(cands):
    return [(c.backend, c.tile_h, c.micro_batch) for c in cands]


@pytest.mark.parametrize("h,max_batch,c_in", [(12, 4, 12), (48, 4, 12),
                                              (84, 8, 12), (128, 8, 4)])
def test_default_candidates_equal_the_reference_grid(h, max_batch, c_in):
    """Where neither package's max_safe_batch falls in [1, max_batch], the
    two grids are the same, in the same order."""
    jcfg, tcfg = _pair(h, max_batch, c_in)
    jplan, jhead = j_tuning._plan_and_head(jcfg)
    j_safe = jplan.max_safe_batch(head=jhead, tile_h=jcfg.tile_h)
    t_safe = tcfg.spec.plan(h).max_safe_batch()
    assert not 1 <= j_safe <= max_batch and not 1 <= t_safe <= max_batch
    assert _as_tuples(t_tuning.default_candidates(tcfg)) == \
        _as_tuples(j_tuning.default_candidates(jcfg))
    assert t_tuning.baseline_candidate(tcfg) == Candidate(
        *_as_tuples([j_tuning.baseline_candidate(jcfg)])[0])


def test_default_candidates_differ_only_by_each_packages_safe_batch():
    """At 84x84 and max_batch 128 the reference adds its VMEM-safe 42
    frames and the port the frames that fill one wave of K4's blocks;
    every other micro-batch's candidates are the same."""
    jcfg, tcfg = _pair(84, 128)
    t_safe = tcfg.spec.plan(84).max_safe_batch()
    assert 1 <= t_safe <= 128 and t_safe != 42
    ref = _as_tuples(j_tuning.default_candidates(jcfg))
    port = _as_tuples(t_tuning.default_candidates(tcfg))
    assert ({c[2] for c in port} ==
            {c[2] for c in ref if c[2] != 42} | {t_safe})
    assert [c for c in port if c[2] != t_safe] == \
        [c for c in ref if c[2] not in (42, t_safe)]
    jcfg, tcfg = _pair(400, 64, c_in=4)        # port: 12 frames fill a wave
    micro = {c.micro_batch for c in t_tuning.default_candidates(tcfg)}
    assert micro == {1, 2, 4, 8, 12, 16, 32, 64}


@pytest.mark.parametrize("max_batch,micro", [(8, 1), (8, 3), (8, 8),
                                             (8, 16), (64, 16), (5, 2)])
def test_serving_cost_equals_the_reference(max_batch, micro):
    jcfg, tcfg = _pair(12, max_batch)
    for t in (1e-4, 3.3e-3, 0.25):
        assert t_tuning._serving_cost(
            tcfg, Candidate("fused", 4, micro), t) == j_tuning._serving_cost(
            jcfg, j_tuning.Candidate("fused", 4, micro), t)


def test_tunedplan_roundtrips_in_both_packages():
    tp = TunedPlan(backend="grouped", tile_h=4, micro_batch=3, time_s=1.5e-4,
                   per_frame_s=2e-5, mode="cuda",
                   host="linux/x86_64/NVIDIA H100 80GB HBM3/8", searched=9,
                   pruned=39)
    assert TunedPlan.from_dict(tp.to_dict()) == tp
    assert TunedPlan.from_dict(json.loads(json.dumps(tp.to_dict()))) == tp
    assert j_tuning.TunedPlan.from_dict(tp.to_dict()).to_dict() == \
        tp.to_dict()
    assert tp.measured_by_port
    with pytest.raises(ValueError, match="unknown TunedPlan"):
        TunedPlan.from_dict({**tp.to_dict(), "wat": 1})
    cfg = dataclasses.replace(_pair(24, 4)[1], tuning=tp)
    assert t_deploy.DeploymentConfig.from_json(cfg.to_json()) == cfg
    assert JConfig.from_json(cfg.to_json()).tuning.mode == "cuda"


@pytest.mark.parametrize("h,max_batch,c_in", [(12, 4, 12), (84, 8, 12),
                                              (400, 64, 4)])
def test_pruning_keeps_the_optimum_the_baseline_and_every_backend(
        h, max_batch, c_in):
    cfg = _pair(h, max_batch, c_in)[1]
    cands = t_tuning.default_candidates(cfg)
    kept, n_pruned = t_tuning.prune_candidates(cfg, cands)
    opt = min(cands, key=lambda c: t_tuning.estimated_cost_s(cfg, c))
    assert opt in kept
    assert t_tuning.baseline_candidate(cfg) in kept
    assert {c.backend for c in kept} == set(backend_names())
    assert n_pruned == len(cands) - len(kept) > 0


def test_cost_model_sees_the_streamed_kernels_resident_blocks():
    """At 64 frames of 400x400x4 both fused kernels spread the frames'
    tiles over every SM, two blocks resident on each (K4 with its second
    input buffer too), and the model ranks the two within 5% of each
    other.  Within one wave fused+stream is fused."""
    cfg = _pair(400, 64, c_in=4)[1]
    plan = cfg.spec.plan(400)
    assert plan.tile_plan(64, streamed=True).blocks_per_sm == 2
    assert plan.tile_plan(64).blocks_per_sm == 2
    fused = t_tuning.estimated_cost_s(cfg, Candidate("fused", 8, 64))
    stream = t_tuning.estimated_cost_s(cfg, Candidate("fused+stream", 8, 64))
    safe = plan.max_safe_batch()
    within = t_tuning.estimated_cost_s(cfg, Candidate("fused+stream", 8,
                                                      safe))
    assert 0.95 <= stream / fused <= 1.05
    assert within == t_tuning.estimated_cost_s(cfg,
                                               Candidate("fused", 8, safe))


def test_launch_feasible_refuses_grouped_layers_past_shared_memory():
    wide = MiniConvSpec((LayerSpec(4, 2, 12, 320, "relu"),))
    cfg = t_deploy.DeploymentConfig(spec=wide, in_h=16, in_w=16)
    assert not t_tuning.launch_feasible(cfg, Candidate("grouped", 4, 8))
    assert t_tuning.launch_feasible(cfg, Candidate("fused", 4, 8))
    kept, _ = t_tuning.prune_candidates(cfg, t_tuning.default_candidates(cfg))
    assert "grouped" not in {c.backend for c in kept}
    assert t_tuning.launch_feasible(_pair(84, 8)[1],
                                    Candidate("grouped", 8, 8))


def test_tune_is_deterministic_under_a_measure_stub():
    cfg = _pair(12, 4)[1]
    stub = lambda c, cand: t_tuning.estimated_cost_s(c, cand)
    lines = []
    t1 = t_tuning.tune(cfg, measure=stub, device="cpu", log=lines.append)
    t2 = t_tuning.tune(cfg, measure=stub, device="cpu")
    assert t1 == t2
    assert t1.mode == "eager" and t1.measured_by_port
    assert t1.searched == len(lines) > 0 and t1.pruned > 0
    kept, _ = t_tuning.prune_candidates(cfg,
                                        t_tuning.default_candidates(cfg))
    assert Candidate(t1.backend, t1.tile_h, t1.micro_batch) in kept
    assert t_tuning.suggest_tuning(cfg) == t_tuning.suggest_tuning(cfg)


def test_tune_is_deterministic_under_a_timer_stub():
    """With a fake timer the real measurement path (build, run the plain
    versions on the CPU) returns identical medians, so two tunes pick the
    same winner."""
    cfg = _pair(12, 2)[1]
    cands = [Candidate("xla", 2, 2), Candidate("grouped", 2, 2),
             Candidate("fused+stream", 2, 1), Candidate("fused", 2, 2)]

    def make_timer():
        t = itertools.count()
        return lambda: float(next(t))

    t1 = t_tuning.tune(cfg, candidates=cands, iters=3, timer=make_timer(),
                       device="cpu")
    t2 = t_tuning.tune(cfg, candidates=cands, iters=3, timer=make_timer(),
                       device="cpu")
    assert t1 == t2 and t1.time_s == 1.0
    assert t1.backend in {c.backend for c in cands}
    assert t_tuning.measure_candidate(cfg, cands[1], iters=2,
                                      device="cpu") > 0.0


def test_cli_tunes_writes_and_rebuilds_from_the_manifest(tmp_path, capsys):
    out = tmp_path / "m.json"
    t_deploy.main(["--tune", "--device", "cpu", "--x", "24",
                   "--max-batch", "4", "--tune-iters", "2", "--out",
                   str(out)])
    text = capsys.readouterr().out
    assert "tuned: backend=" in text and "manifest TunedPlan" in text
    cfg = t_deploy.DeploymentConfig.from_json(out.read_text())
    assert cfg.tuning.mode == "eager" and cfg.tuning.searched > 0
    dep = t_deploy.Deployment.build(cfg, device="cpu")
    assert dep.backend.name == cfg.tuning.backend
    assert any("manifest TunedPlan" in line for line in dep.build_log)


def test_frame_time_benchmark_writes_its_own_artifact_only(tmp_path):
    committed = ROOT / "BENCH_frame_time.json"
    before = hashlib.sha256(committed.read_bytes()).hexdigest()
    assert Path(frame_time.ARTIFACT).name != committed.name
    assert Path(frame_time.ARTIFACT).parent.name == "build"
    art = tmp_path / "ft.json"
    rows = frame_time.run((16,), n=2, modes=("xla", "grouped"),
                          device="cpu", artifact=str(art))
    assert rows[0]["x"] == 16 and rows[0]["grouped_ms"] > 0
    doc = json.loads(art.read_text())
    assert doc["mode"] == "eager" and doc["backend"] == "xla,grouped"
    rows, ok = frame_time.run_tune((16,), n=2, max_batch=2, iters=1,
                                   device="cpu", artifact=str(art))
    assert rows[0]["tuned_backend"] in backend_names()
    assert json.loads(art.read_text())["kind"] == "tune"
    with pytest.raises(ValueError, match="committed"):
        frame_time.run((16,), n=1, device="cpu",
                       artifact=str(tmp_path / "BENCH_frame_time.json"))
    assert hashlib.sha256(committed.read_bytes()).hexdigest() == before
