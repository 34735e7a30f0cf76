"""The port's latency benchmarks end to end on the CPU, and the Full-CNN
server-only baseline against the reference.

``full_cnn_apply`` on the reference's converted parameters stays within
1e-4 of the JAX network.  ``decision_latency``, ``scalability --smoke`` and
``break_even --manifest`` run end to end with ``--device cpu`` at a small
manifest (36x36: the NatureCNN baseline's three VALID convs need at least
that), and without ``--device`` they raise on a host with no CUDA rather
than fall back.  The fleet table equals the reference's on the same t(B)
curve, and the quickstart runs.
"""
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro import deploy as j_deploy
from repro.rl import networks as j_networks
from repro.serving import server as j_srv
from repro_torch import deploy as t_deploy
from repro_torch.benchmarks import break_even, decision_latency, scalability
from repro_torch.convert import params_from_jax
from repro_torch.examples import quickstart
from repro_torch.rl import networks as t_networks
from repro_torch.serving import server as t_srv

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CNN_TOL = 1e-4


@pytest.mark.parametrize("shape", [(2, 84, 84, 12), (3, 36, 40, 4)])
def test_full_cnn_matches_reference(shape):
    b, h, w, c = shape
    jp = j_networks.full_cnn_init(jax.random.PRNGKey(3), c, h=h, w=w)
    obs = np.random.default_rng(0).random(shape, dtype=np.float32)
    want = np.asarray(j_networks.full_cnn_apply(jp, obs))
    tp = params_from_jax(jp, device="cpu")
    got = t_networks.full_cnn_apply(tp, torch.from_numpy(obs))
    assert got.shape == (b, 512) and want.shape == (b, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=CNN_TOL, rtol=CNN_TOL)
    # the port's own init has the reference's tree, shapes and layout
    ti = t_networks.full_cnn_init(torch.Generator().manual_seed(0), c, h=h,
                                  w=w, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in ti.items()}


def test_full_cnn_refuses_inputs_below_its_receptive_field():
    with pytest.raises(ValueError, match="36x36"):
        t_networks.full_cnn_init(torch.Generator(), 4, h=24, w=24,
                                 device="cpu")


def _small_config(**kw):
    return t_deploy.DeploymentConfig.standard(k=4, c_in=12, h=36,
                                              max_batch=8, **kw)


def _manifest(tmp_path, **kw):
    path = tmp_path / "m.json"
    path.write_text(_small_config(**kw).to_json())
    return str(path)


def test_decision_latency_run_and_queue_on_cpu(capsys):
    setup = decision_latency.build(
        config=_small_config(n_servers=2, router="least_loaded"),
        device="cpu")
    assert setup.deployment.device.type == "cpu"
    assert setup.wire_bytes == 5 * 5 * 4 + 8     # 36 -> 18 -> 9 -> 5
    assert setup.frame_bytes == 36 * 36 * 12
    rows = decision_latency.run((10, 100), n_decisions=20, setup=setup)
    assert [r["mbps"] for r in rows] == [10, 100]
    for r in rows:
        # both pipelines pay at least the 4 ms round trip
        assert 4.0 < r["split_ms"] < 1e3 and 4.0 < r["server_only_ms"] < 1e3
    row = decision_latency.run_queue(n_clients=8, setup=setup)
    assert sorted(row["service_ms"]) == [1, 2, 4, 8]
    assert row["n_servers"] == 2 and row["router"] == "least_loaded"
    assert np.isfinite([row["fifo_p95_ms"], row["batched_p95_ms"],
                        row["fleet_p95_ms"]]).all()
    out = capsys.readouterr().out
    assert "batched service curve" in out and "fleet (2 servers" in out


def test_decision_latency_cli_on_cpu(tmp_path, capsys):
    decision_latency.main(["--device", "cpu", "--manifest",
                           _manifest(tmp_path), "--decisions", "10",
                           "--bandwidths", "10,50", "--clients", "4"])
    out = capsys.readouterr().out
    assert "10.0 Mb/s  server-only" in out and "50.0 Mb/s" in out
    assert "N=4 @ 10Hz: p95 FIFO" in out


def test_scalability_smoke_on_cpu(tmp_path, capsys):
    scalability.main(["--smoke", "--no-fleet", "--device", "cpu",
                      "--manifest", _manifest(tmp_path)])
    out = capsys.readouterr().out
    assert "smoke: batched p95" in out and ": True" in out
    assert "server_only" in out and "split_batched" in out


def test_fleet_table_equals_reference():
    ref = _load_reference_benchmark("scalability")
    points = ((1, 0.02), (2, 0.03), (4, 0.045), (8, 0.07))
    jcfg = j_deploy.DeploymentConfig.standard(k=4, c_in=12, h=24,
                                              backend="xla", n_servers=3,
                                              router="client_affinity")
    td = t_deploy.Deployment.build(
        t_deploy.DeploymentConfig.from_json(jcfg.to_json()), device="cpu")
    jd = j_deploy.Deployment.build(jcfg)
    kw = dict(mbps=100.0, horizon_s=1.0, n_servers_list=(1, 2, 4),
              n_max=32, max_batch=8, max_wait_s=0.0)
    got = scalability.fleet_table(types.SimpleNamespace(deployment=td),
                                  t_srv.BatchServiceModel(points), **kw)
    want = ref.fleet_table(types.SimpleNamespace(deployment=jd),
                           j_srv.BatchServiceModel(points), **kw)
    assert got == want and set(got["round_robin"]) == {1, 2, 3, 4}
    assert any(v < 32 for row in got.values() for v in row.values())
    for gain in (0.0, 2.0, 50.0):
        assert scalability.check_fleet_monotone(got, min_gain_at_4x=gain,
                                                n_max=32) == \
            ref.check_fleet_monotone(want, min_gain_at_4x=gain, n_max=32)
    bad = {"round_robin": {1: 10, 2: 9, 4: 30}}
    assert not scalability.check_fleet_monotone(bad)


def test_break_even_manifest_on_cpu(tmp_path, capsys):
    break_even.main(["--manifest", _manifest(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(measured)" in out and "simulated crossover" in out
    cfg, dep = break_even.split_config_from_manifest(
        _manifest(tmp_path), encode_time_s=1e-3, device="cpu")
    assert (cfg.x_size, cfg.n_stride2, cfg.k_channels) == (36, 3, 4)
    assert dep.device.type == "cpu"
    row = break_even.run_manifest(_manifest(tmp_path), device="cpu")
    assert abs(row["pred"] - row["sim"]) / row["pred"] < 0.02


def _load_reference_benchmark(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("entry", [
    lambda m: decision_latency.main(["--manifest", m, "--clients", "0"]),
    lambda m: scalability.main(["--smoke", "--manifest", m]),
    lambda m: break_even.main(["--manifest", m]),
    lambda m: quickstart.main([]),
], ids=["decision_latency", "scalability", "break_even", "quickstart"])
def test_entry_points_need_cuda_unless_told_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(_manifest(tmp_path))


def test_quickstart_runs_on_cpu(capsys):
    assert round(quickstart.main(["--device", "cpu"]), 1) == 50.4
    out = capsys.readouterr().out
    assert "wire 492 bytes" in out and "84672" in out
