"""The port's training driver against the reference (``repro.rl.train``,
``repro.rl.rollout``), on the CPU.

Plans, ring capacities and episode statistics are integer and numpy
arithmetic: equal to the reference's exactly.  Training curves are never
compared (the two frameworks' generators never agree); each pairing trains
at the reference tests' ``SMALL`` configs on the CPU and must finish with
finite parameters that moved.  The trained DDPG policy served through its
manifest equals the in-process policy on the same observation.
"""
import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.rl import rollout as j_rollout
from repro.rl.ddpg import DDPGConfig as JDDPG
from repro.rl.ppo import PPOConfig as JPPO
from repro.rl.sac import SACConfig as JSAC
from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.envs import make_pixel_env
from repro_torch.nn.module import tree_leaves
from repro_torch.rl import rollout as t_rollout
from repro_torch.rl.agent import make_agent
from repro_torch.rl.ddpg import DDPGConfig as TDDPG
from repro_torch.rl.ppo import PPOConfig as TPPO
from repro_torch.rl.sac import SACConfig as TSAC

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

# the packages export the ``train`` function under the module's name
j_train = importlib.import_module("repro.rl.train")
t_train = importlib.import_module("repro_torch.rl.train")

SMALL = {
    "sac": dict(batch_size=8, buffer_size=64, learning_starts=8, n_envs=2),
    "ddpg": dict(batch_size=8, buffer_size=64, learning_starts=8, n_envs=2),
    "ppo": dict(n_envs=2, n_steps=8, n_epochs=1, n_minibatches=2),
}
T_CFG = {"sac": TSAC, "ddpg": TDDPG, "ppo": TPPO}
J_CFG = {"sac": JSAC, "ddpg": JDDPG, "ppo": JPPO}


def _small(algo):
    return T_CFG[algo](**SMALL[algo])


def test_configs_match_reference_field_for_field():
    for algo in T_CFG:
        t, j = T_CFG[algo](), J_CFG[algo]()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert T_CFG[algo].VMAPPABLE == J_CFG[algo].VMAPPABLE
    assert t_train.TASK_ALGO == j_train.TASK_ALGO
    assert t_rollout.CHUNK == j_rollout.CHUNK


@pytest.mark.parametrize("algo", ["sac", "ddpg"])
def test_offpolicy_plan_and_capacity_equal_reference(algo):
    for kw in (SMALL[algo], {}, dict(n_envs=3, batch_size=50,
                                     learning_starts=7, buffer_size=999)):
        tcfg, jcfg = T_CFG[algo](**kw), J_CFG[algo](**kw)
        for budget in (1, 5, 6, 40, 64, 128, 300, 999, 1000, 20_000,
                       100_003):
            assert (t_rollout.offpolicy_plan(tcfg, budget)
                    == j_rollout.offpolicy_plan(jcfg, budget))
            assert (t_rollout.offpolicy_capacity(tcfg, budget)
                    == j_rollout.offpolicy_capacity(jcfg, budget))


def test_onpolicy_plan_equals_reference():
    for kw in (SMALL["ppo"], {}, dict(n_envs=3, n_steps=5)):
        tcfg, jcfg = TPPO(**kw), JPPO(**kw)
        for budget in (0, 1, 15, 16, 64, 1023, 1024, 20_000):
            assert (t_rollout.onpolicy_plan(tcfg, budget)
                    == j_rollout.onpolicy_plan(jcfg, budget))


def test_episode_statistics_equal_reference():
    rng = np.random.default_rng(0)
    rewards = rng.standard_normal((40, 3))
    dones = rng.random((40, 3)) < 0.15
    out = {}
    for mod in (t_train, j_train):
        returns, ep_ret, ep_len = [], np.zeros(3), np.zeros(3, np.int64)
        for chunk in range(0, 40, 16):
            ep_ret, ep_len = mod._track_episodes(
                returns, ep_ret, ep_len, rewards[chunk:chunk + 16],
                dones[chunk:chunk + 16])
        truncated = mod._flush_truncated(ep_ret, ep_len)
        res = mod.TrainResult("hopper", "sac", "miniconv4", returns, 2.0,
                              truncated_returns=truncated, env_steps=120,
                              compile_s=0.5, steady_env_steps=60,
                              steady_wall_s=1.0)
        out[mod] = (returns, truncated, res.summary(), res.all_returns)
    assert out[t_train] == out[j_train]
    for mod in (t_train, j_train):
        empty = mod.TrainResult("pendulum", "ddpg", "miniconv4", [], 1.0)
        assert np.isnan(empty.best) and empty.summary()["episodes"] == 0


@pytest.mark.parametrize("task,algo,steps", [("pendulum", "ddpg", 48),
                                             ("hopper", "sac", 48),
                                             ("walker", "ppo", 32)])
def test_train_each_pairing_on_the_cpu(task, algo, steps):
    res = t_train.train(task, "miniconv4", total_steps=steps,
                        cfg=_small(algo), seed=1, device="cpu")
    plan = (t_rollout.onpolicy_plan if algo == "ppo"
            else t_rollout.offpolicy_plan)(_small(algo), steps)
    # one (phase, seconds, metrics) a phase of the plan, and the carry
    # the run ended with
    assert [p for p, _, _ in res.phases] == plan
    assert all(dt > 0 for _, dt, _ in res.phases)
    assert res.carry.state.params is res.params
    assert res.algo == algo and res.env_steps == steps
    assert res.summary()["episodes"] >= 2       # >= one partial per env
    assert np.isfinite(res.mean)
    leaves = tree_leaves(res.params)
    assert leaves and all(torch.isfinite(x).all() for x in leaves)
    assert all(x.device.type == "cpu" for x in leaves)
    # the parameters moved from their initial values
    init = make_agent(algo, t_train._pipeline_encoder(
        "miniconv4", 9, device="cpu"), make_pixel_env(task).action_dim,
        cfg=_small(algo), device="cpu").init(torch.Generator().manual_seed(1))
    moved = [not torch.equal(a, b)
             for a, b in zip(leaves, tree_leaves(init.params))]
    assert any(moved)
    # every loss finite
    metrics = [m for _, _, m in res.phases if m]
    assert metrics and all(torch.isfinite(v).all()
                           for m in metrics for v in m.values())


def test_trained_policy_serves_from_manifest():
    """train(deploy_config=...) -> TrainResult.params ->
    Deployment.serving_pair: the EdgeClient -> wire ->
    BatchingPolicyServer action equals the in-process policy."""
    cfg = DeploymentConfig.from_encoder_name("miniconv4", c_in=9,
                                             backend="xla")
    res = t_train.train("pendulum", "miniconv4", total_steps=16,
                        cfg=_small("ddpg"), deploy_config=cfg, seed=3,
                        device="cpu")
    dep = Deployment.build(cfg, device="cpu")
    agent = make_agent("ddpg", dep.encoder, 1, cfg=_small("ddpg"),
                       device="cpu")
    head = agent.policy_head(res.params)
    env = make_pixel_env("pendulum", train=False)
    _, obs = env.reset_batch(torch.Generator().manual_seed(0), 1)

    client, server = dep.serving_pair(res.params, head=head)
    served = server.serve([client.encode_fn(obs)])[0]

    enc = res.params["encoder"]
    with torch.inference_mode():
        feats = dep.split.server_step(enc["server"],
                                      dep.split.edge_step(enc["edge"], obs))
        inproc = head(feats)[0]
        float_action = head(dep.encoder.apply(enc, obs))[0]
    np.testing.assert_allclose(served.numpy(), inproc.numpy(), rtol=1e-5,
                               atol=1e-6)
    # only uint8 feature quantisation separates it from the float policy
    np.testing.assert_allclose(served.numpy(), float_action.numpy(),
                               atol=0.25)
    assert served.shape == (1,)
    # the fused build of the same manifest serves the same action (its
    # kernel's plain version on the CPU)
    dep_f = Deployment.build(dataclasses.replace(cfg, backend="fused"),
                             device="cpu")
    client_f, server_f = dep_f.serving_pair(res.params, head=head)
    fused = server_f.serve([client_f.encode_fn(obs)])[0]
    np.testing.assert_allclose(fused.numpy(), served.numpy(), atol=1e-3)


def test_train_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.train("pendulum", "miniconv4", total_steps=8,
                      cfg=_small("ddpg"))
    from repro_torch.examples import train_split_policy
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_split_policy.main(["--steps", "8"])


def test_example_main_at_a_tiny_budget(capsys):
    from repro_torch.examples import train_split_policy
    out = train_split_policy.main(["--device", "cpu", "--steps", "8"])
    assert out["summary"]["env_steps"] == 8
    assert [r[0] for r in out["rows"]] == [10, 25, 50, 100]
    # each cell is the decision loop's arithmetic on the stage times the
    # example measured (which one is faster on a loaded CPU is not a
    # property of the code): split = edge + upload + server + the
    # action's return, server-only the raw frame's upload + server
    from repro_torch.serving.client import DecisionLoop
    from repro_torch.serving.netsim import shaped
    edge, srv = out["edge_s"], out["server_s"]
    # 9 channels travel as 12 (RGBA textures); the uint8 map is 492 B
    assert out["wire_bytes"] == 492 and out["frame_bytes"] == 84 * 84 * 12
    for mbps, so_ms, sp_ms in out["rows"]:
        link = shaped(mbps)
        so = DecisionLoop(link=link, server_time_s=srv, split=False,
                          payload_bytes=out["frame_bytes"])
        sp = DecisionLoop(link=link, server_time_s=srv, split=True,
                          edge_time_s=edge, payload_bytes=out["wire_bytes"])
        assert so_ms == so.median_latency(100) * 1e3
        assert sp_ms == sp.median_latency(100) * 1e3
        back = link.tx_time(64) + link.propagation_s
        assert sp_ms == pytest.approx((edge + link.tx_time(out["wire_bytes"])
                                       + link.propagation_s + srv + back)
                                      * 1e3, rel=1e-12)
        assert so_ms == pytest.approx((link.tx_time(out["frame_bytes"])
                                       + link.propagation_s + srv + back)
                                      * 1e3, rel=1e-12)
    assert "deployment (fused on cpu)" in capsys.readouterr().out
