"""The port's scenario engine and the deployment's simulators against the
reference.

Every registered scenario, run by ``ScenarioFleetSim.report`` under each
adaptation controller and at 1 and 2 servers, gives the reference's
latencies, mode choices, uplink bytes, delivered return and hit rate bit
for bit (the registered horizons of 10-12 s are kept: a run is about a
thousand requests).  Scenario JSON written by ``repro.serving.scenario``
loads in the port and round-trips unchanged.  ``Deployment.fleet_sim`` /
``scenario_sim`` equal the reference's, keyword overrides included, and
``python -m repro_torch.deploy --scenario`` prints the reference's
scorecard on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import deploy as j_deploy
from repro.serving import netsim as j_net
from repro.serving import scenario as j_sc
from repro.serving import server as j_srv
from repro_torch import deploy as t_deploy
from repro_torch import serving as t_serving
from repro_torch.schema import SchemaVersionError
from repro_torch.serving import netsim as t_net
from repro_torch.serving import scenario as t_sc
from repro_torch.serving import server as t_srv

NAMES = ("static_100mbps", "static_10mbps", "zoo_static", "jittery_wifi",
         "lossy_uplink", "trace_dropout", "wifi_markov")
PAYLOAD = 492


def test_registry_equals_reference():
    assert t_sc.scenario_names() == j_sc.scenario_names() == NAMES
    assert t_sc.adaptation_names() == j_sc.adaptation_names()
    for name in NAMES:
        assert t_sc.get_scenario(name).to_dict() == \
            j_sc.get_scenario(name).to_dict()
    # the package re-exports what the reference's package does, the real
    # multi-process fleet included
    from repro import serving as j_serving
    from repro_torch.serving import realfleet as t_rf
    assert t_serving.SCENARIOS is t_sc.SCENARIOS
    assert t_serving.ScenarioFleetSim is t_sc.ScenarioFleetSim
    assert t_serving.RealFleet is t_rf.RealFleet
    assert t_serving.__all__ == j_serving.__all__


def _same_report(t, j):
    assert np.array_equal(t.latencies, j.latencies)
    assert t.latencies.tobytes() == j.latencies.tobytes()
    assert np.array_equal(t.mode_idx, j.mode_idx)
    assert t.total_uplink_bytes == j.total_uplink_bytes
    assert t.delivered_return == j.delivered_return
    assert t.deadline_hit_rate == j.deadline_hit_rate
    assert t.mode_counts() == j.mode_counts()
    assert t.mode_names == j.mode_names


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("adaptation", ["none", "rule", "static:0"])
@pytest.mark.parametrize("n_servers,router", [(1, "round_robin"),
                                              (2, "least_loaded")])
def test_every_scenario_report_equals_reference(name, adaptation, n_servers,
                                                router):
    t = t_sc.get_scenario(name)
    j = j_sc.get_scenario(name)
    kw = dict(n_servers=n_servers, router=router, adaptation=adaptation)
    rt = t.sim(PAYLOAD, **kw).report(t.n_clients)
    rj = j.sim(PAYLOAD, **kw).report(j.n_clients)
    _same_report(rt, rj)
    # same name and seed in, bitwise-identical latencies out
    _same_report(t.sim(PAYLOAD, **kw).report(t.n_clients), rt)


@pytest.mark.parametrize("name", NAMES)
def test_reference_scenario_json_loads_and_roundtrips(name):
    text = j_sc.get_scenario(name).to_json()
    sc = t_sc.Scenario.from_json(text)
    assert sc == t_sc.get_scenario(name)
    assert sc.to_dict() == json.loads(text)
    assert t_sc.Scenario.from_json(sc.to_json()) == sc
    # ... and the port's JSON loads in the reference
    assert j_sc.Scenario.from_json(sc.to_json()) == j_sc.get_scenario(name)


def test_scenario_json_version_refused():
    d = t_sc.get_scenario("wifi_markov").to_dict()
    d["version"] = 99
    with pytest.raises(SchemaVersionError, match="version"):
        t_sc.Scenario.from_dict(d)


def test_custom_adaptation_and_reseed_equal_reference():
    def factory(sc_mod):
        class Alternate:
            def __init__(self, modes, payload_bytes, deadline_s):
                self.n = len(modes)

            def choose(self, client, t_obs):
                return int(t_obs * 10) % self.n

            def observe(self, client, mode_idx, t_send, trace):
                pass
        return Alternate
    for name in ("trace_dropout", "wifi_markov"):
        t = dataclasses.replace(t_sc.get_scenario(name), seed=99)
        j = dataclasses.replace(j_sc.get_scenario(name), seed=99)
        _same_report(t.sim(PAYLOAD, adaptation=factory(t_sc)).report(5),
                     j.sim(PAYLOAD, adaptation=factory(j_sc)).report(5))


# ------------------------------------------------------------ deployment
def _deployments(**kw):
    jcfg = j_deploy.DeploymentConfig.standard(k=4, c_in=12, h=24,
                                              backend="xla", **kw)
    tcfg = t_deploy.DeploymentConfig.from_json(jcfg.to_json())
    return (t_deploy.Deployment.build(tcfg, device="cpu"),
            j_deploy.Deployment.build(jcfg))


def test_routers_come_from_the_fleet():
    from repro_torch.serving.fleet import ROUTERS
    assert t_deploy.ROUTERS is ROUTERS
    with pytest.raises(ValueError, match="unknown router"):
        t_deploy.DeploymentConfig.standard(router="nope").validate()


@pytest.mark.parametrize("kw,over", [
    ({}, {}),
    ({"n_servers": 4, "router": "least_loaded", "max_batch": 4,
      "max_wait_ms": 5.0}, {}),
    ({"n_servers": 4, "router": "least_loaded"},
     {"n_servers": 2, "router": "client_affinity", "max_batch": 2,
      "max_wait_s": 0.002}),
])
def test_deployment_fleet_sim_equals_reference(kw, over):
    td, jd = _deployments(**kw)
    assert td.wire_bytes == jd.wire_bytes
    points = ((1, 0.004), (2, 0.005), (4, 0.0068), (8, 0.011))
    ts = td.fleet_sim(t_srv.BatchServiceModel(points),
                      uplink=t_net.shaped(20.0), horizon_s=2.0, **over)
    js = jd.fleet_sim(j_srv.BatchServiceModel(points),
                      uplink=j_net.shaped(20.0), horizon_s=2.0, **over)
    assert (ts.n_servers, ts.router, ts.max_batch, ts.max_wait_s) == \
        (js.n_servers, js.router, js.max_batch, js.max_wait_s)
    for n in (4, 32):
        assert np.array_equal(ts.trace(n), js.trace(n))


@pytest.mark.parametrize("name,over", [
    ("lossy_uplink", {"adaptation": "rule"}),
    ("zoo_static", {}),
    ("wifi_markov", {"n_servers": 3, "router": "round_robin",
                     "adaptation": "rule"}),
    ("trace_dropout", {"max_batch": 2, "max_wait_s": 0.003,
                       "adaptation": "static:1"}),
])
def test_deployment_scenario_sim_equals_reference(name, over):
    td, jd = _deployments(n_servers=2, router="least_loaded")
    rt = td.scenario_sim(name, **over).report(8)
    rj = jd.scenario_sim(name, **over).report(8)
    _same_report(rt, rj)
    points = ((1, 0.002), (4, 0.003), (8, 0.0045))
    rt = td.scenario_sim(name, service_model=t_srv.BatchServiceModel(points),
                         **over).report(8)
    rj = jd.scenario_sim(name, service_model=j_srv.BatchServiceModel(points),
                         **over).report(8)
    _same_report(rt, rj)


@pytest.mark.parametrize("name", ["trace_dropout", "zoo_static"])
def test_scenario_cli_prints_the_reference_scorecard(name, tmp_path,
                                                     capsys):
    t_deploy.main(["--x", "24", "--device", "cpu", "--n-servers", "2",
                   "--router", "least_loaded", "--scenario", name,
                   "--out", str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert "fleet=2x/least_loaded" in out
    got = [line for line in out.splitlines()
           if line.startswith(("  scenario ", "    "))]
    jcfg = j_deploy.DeploymentConfig.from_json(
        (tmp_path / "m.json").read_text())
    j_deploy._scenario_report(j_deploy.Deployment.build(jcfg), name)
    want = capsys.readouterr().out.splitlines()
    assert got == want and len(want) >= 2
