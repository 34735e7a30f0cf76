"""The port's populations (``repro_torch.rl.population``) against the
reference (``repro.rl.population``), on the CPU.

The spec, its programs, the serialisation and ``final_100_mean`` are
Python and numpy arithmetic: equal to the reference's exactly.  Training
curves are never compared across the packages (their generators never
agree); parity is held per update on fixed batches with the reference's
draws.  Tolerances, each with the largest error measured when it was set:

* one update, the port's lanes against the reference's (exact against
  exact, vmap against vmap): PR 19's — losses 1e-4 relative, gradients
  (the first Adam moment from zero) 1e-4 of each leaf's largest element,
  parameters ``2 * lr`` (Adam's first step is about ``lr * sign(g)``),
  targets ``4 * lr * tau`` (measured: losses 1.3e-6, gradients 6.9e-6,
  parameters 0.0034 lr);
* one update, the port's vmap lanes against its exact lanes: losses
  1e-5 relative, gradients 1e-5 of each leaf's largest element
  (measured 1.6e-6 and 6.1e-6, SAC's), parameters ``2 * lr`` as above
  (measured 0.0024 lr); an ``lr = 0`` member's parameters bitwise
  unchanged in all four;
* 32 training steps, the port's vmap lanes against its exact lanes (the
  same draws in the same order): episode returns 1e-4 relative (measured
  2.6e-8), parameters ``2 * lr`` (measured 1.6e-5 at lr 1e-3);
* the population env step against the reference's on converted states:
  states and rewards 1e-5, frames equal (the dynamics tolerance of
  ``tests/test_torch_envs.py``);
* the eval protocol against the reference's on converted parameters and
  the reference's initial states, 20 steps: 1e-5 relative to the
  returns' scale (measured 1.3e-7);
* the port's vmap evaluator against its exact one: 1e-5 relative
  (measured 1.1e-7).

Everything within the port is bitwise: population env rows against
per-member calls, exact member 0 against ``train()``, frozen ``lr = 0``
lanes, permuted members, evaluator replay, and ``export_best`` against
``serving_pair(best_params())``.
"""
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.deploy import Deployment as JDeployment
from repro.deploy import DeploymentConfig as JConfig
from repro.envs import make_pixel_env as j_make_pixel_env
from repro.rl import population as j_pop
from repro.rl.agent import make_agent as j_make_agent
from repro.rl.ddpg import DDPGConfig as JDDPG
from repro.rl.ppo import PPOConfig as JPPO
from repro.rl.sac import SACConfig as JSAC
from repro.train import optimizer as j_opt
from repro_torch.convert import (params_from_jax,
                                 stacked_train_state_from_jax)
from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.envs import make_pixel_env
from repro_torch.envs import wrappers as t_wrappers
from repro_torch.nn.module import tree_leaves
from repro_torch.rl import population as t_pop
from repro_torch.rl.agent import make_agent
from repro_torch.rl.ddpg import DDPGConfig as TDDPG
from repro_torch.rl.ppo import PPOConfig as TPPO
from repro_torch.rl.sac import SACConfig as TSAC
from repro_torch.train import optimizer as t_opt

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

t_train = importlib.import_module("repro_torch.rl.train")

CPU = "cpu"
SMALL = {"batch_size": 8, "buffer_size": 64, "learning_starts": 8,
         "n_envs": 2}
STEPS = 32
PPO_SMALL = {"n_envs": 2, "n_steps": 4, "n_epochs": 1, "n_minibatches": 2}
H = 24          # miniconv4 at 24x24 for the per-update checks
GRAD_RTOL = 1e-4
LANE_RTOL = 1e-5
EVAL_RTOL = 1e-5


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- the spec
SPECS = [
    dict(tasks=("pendulum", "hopper"), seeds=(0, 7),
         variants=({"lr": 1e-3}, {"lr": 1e-4})),
    dict(tasks="pendulum", seeds=(3,),
         variants=({"lr": 1e-3, "gamma": 0.9}, {"batch_size": 16}, {}),
         cfg_overrides={"n_envs": 2}),
    dict(tasks=("walker",), seeds=(0, 1, 2),
         variants=((("clip_eps", 0.1),), (("n_steps", 8), ("lr", 0.0))),
         total_steps=64, encoder="miniconv16"),
]


@pytest.mark.parametrize("kw", SPECS, ids=["two-tasks", "static-split",
                                           "ppo"])
def test_spec_members_programs_and_dicts_equal_reference(kw):
    tspec, jspec = t_pop.PopulationSpec(**kw), j_pop.PopulationSpec(**kw)
    assert tspec.n_members == jspec.n_members
    assert ([dataclasses.astuple(m)[:6] for m in tspec.members()]
            == [dataclasses.astuple(m)[:6] for m in jspec.members()])
    tprogs, jprogs = tspec.programs(), jspec.programs()
    assert len(tprogs) == len(jprogs)
    for tp, jp in zip(tprogs, jprogs):
        assert (tp.task, tp.algo, tp.hyper_fields) == \
            (jp.task, jp.algo, jp.hyper_fields)
        assert (dataclasses.asdict(tp.static_cfg)
                == dataclasses.asdict(jp.static_cfg))
        assert [m.index for m in tp.members] == [m.index for m in jp.members]
        tcols = tp.hyper_arrays(CPU)
        for k, col in jp.hyper_arrays().items():
            assert tcols[k].dtype == torch.float32
            np.testing.assert_array_equal(tcols[k].numpy(), np.asarray(col))
    assert tspec.to_dict() == jspec.to_dict()
    assert t_pop.PopulationSpec.from_dict(jspec.to_dict()) == tspec
    assert t_pop.SPEC_VERSION == j_pop.SPEC_VERSION


def test_spec_refusals_match_reference():
    for mod in (t_pop, j_pop):
        a = mod.PopulationSpec(tasks="pendulum", seeds=(0,),
                               variants=({"lr": 1e-3, "gamma": 0.9},))
        b = mod.PopulationSpec(tasks=("pendulum",), seeds=(0,),
                               variants=((("gamma", 0.9), ("lr", 1e-3)),))
        assert a == b
        with pytest.raises(ValueError, match="unknown task"):
            mod.PopulationSpec(tasks=("cartpole",), seeds=(0,))
        with pytest.raises(ValueError, match="seed"):
            mod.PopulationSpec(tasks=("pendulum",), seeds=())
        with pytest.raises(ValueError, match="no field"):
            mod.PopulationSpec(tasks=("pendulum",), seeds=(0,),
                               variants=({"learning_rate": 1e-3},)
                               ).programs()
        stale = a.to_dict()
        stale["version"] = mod.SPEC_VERSION + 1
        with pytest.raises(ValueError, match="version"):
            mod.PopulationSpec.from_dict(stale)


def test_final_100_mean_equals_reference():
    rng = np.random.default_rng(0)
    for r in ([], [1.0, 2.0, 3.0], [0.0] * 50 + [2.0] * 100,
              rng.standard_normal(250).tolist(),
              rng.standard_normal((3, 40)) * 100):
        want, got = j_pop.final_100_mean(r), t_pop.final_100_mean(r)
        assert (math.isnan(want) and math.isnan(got)) or want == got


# ----------------------------------------------------- population envs
@pytest.mark.parametrize("task", ["pendulum", "hopper", "walker"])
def test_population_env_rows_bitwise_equal_per_member_calls(task):
    env = make_pixel_env(task, train=True)
    P, N = 3, 2
    seeds = (0, 5, 9)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    states, obs = env.reset_population(gens, N)
    assert obs.shape == (P, N, 84, 84, 9)
    assert states.gen == tuple(gens)
    refs = [env.reset_batch(torch.Generator().manual_seed(s), N)
            for s in seeds]
    for p in range(P):
        assert torch.equal(refs[p][1], obs[p])
    rng = np.random.default_rng(1)
    for _ in range(12):
        acts = torch.from_numpy(rng.uniform(-1, 1, (P, N, env.action_dim))
                                .astype(np.float32))
        states, obs, rew, done = env.step_population(states, acts)
        for p in range(P):
            s, o, r, d = env.step_batch(refs[p][0], acts[p])
            refs[p] = (s, o)
            assert torch.equal(o, obs[p]) and torch.equal(r, rew[p])
            assert torch.equal(d, done[p])
            assert torch.equal(s.frames, states.frames[p])
            for x, y in zip(s.inner, states.inner):
                assert torch.equal(x, y[p])


def test_population_env_step_matches_reference():
    """The eval env (centre crop, no crop draw) over 10 steps from the
    reference's ``reset_population`` states: pendulum never ends an
    episode that early, so no reset draw reaches an observation."""
    jenv = j_make_pixel_env("pendulum", train=False)
    tenv = make_pixel_env("pendulum", train=False)
    P, N = 2, 3
    keys = jnp.stack([jax.random.split(jax.random.PRNGKey(s), N)
                      for s in (0, 1)])
    jstates, jobs = jax.jit(jenv.reset_population)(keys)
    inner_cls = type(tenv.env.reset(torch.Generator(), 1))
    tstates = t_wrappers.PixelEnvState(
        inner_cls(*(_t(x) for x in jstates.inner)), _t(jstates.frames),
        tuple(torch.Generator().manual_seed(p) for p in range(P)),
        _t(jstates.episode_return), _t(jstates.step_count))
    np.testing.assert_array_equal(
        t_wrappers._obs(tstates.frames.flatten(0, 1)).numpy(),
        np.asarray(jobs).reshape(P * N, 84, 84, 9))
    step = jax.jit(jenv.step_population)
    rng = np.random.default_rng(2)
    for _ in range(10):
        a = rng.uniform(-1, 1, (P, N, 1)).astype(np.float32)
        jstates, jobs, jr, jd = step(jstates, jnp.asarray(a))
        tstates, tobs, tr, td = tenv.step_population(tstates, _t(a))
        for want, got in zip(jstates.inner, tstates.inner):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))


# ------------------------------------------- training: member 0, lanes
@pytest.fixture(scope="module")
def runs():
    """Seeds (0, 1) x lr (default, 0.0), WITH gradient updates, in both
    lane modes, plus the protocol eval on a shortened window, and the
    single run member 0 must equal."""
    spec = t_pop.PopulationSpec(tasks=("pendulum",), seeds=(0, 1),
                                variants=((), {"lr": 0.0}),
                                total_steps=STEPS, cfg_overrides=SMALL)
    out = {mode: t_pop.train_population(spec, eval_episodes=4,
                                        eval_max_steps=8, lane_mode=mode,
                                        device=CPU)
           for mode in t_pop.LANE_MODES}
    out["single"] = t_train.train("pendulum", "miniconv4",
                                  total_steps=STEPS, seed=0,
                                  cfg=TDDPG(**SMALL), device=CPU)
    return out


def test_exact_member0_bitwise_equals_train_ddpg(runs):
    m0, m1 = runs["exact"].members[0], runs["exact"].members[1]
    single = runs["single"]
    assert _equal(m0.params, single.params)
    want = single.carry.state
    assert _equal(m0.state.target, want.target)
    assert torch.equal(m0.state.opt_state.step, want.opt_state.step)
    assert _equal(m0.state.opt_state.mu, want.opt_state.mu)
    assert _equal(m0.state.opt_state.nu, want.opt_state.nu)
    assert m0.episode_returns == single.episode_returns
    assert m0.truncated_returns == single.truncated_returns
    assert m0.env_steps == single.env_steps == STEPS
    # and the other seed trained a different agent
    assert not _equal(m1.params, single.params)


@pytest.mark.parametrize("mode", ["exact", "vmap"])
def test_lr0_lanes_stay_frozen_at_init(runs, mode):
    res = runs[mode]
    assert len(res.program_stats) == 1
    assert res.program_stats[0]["hyper_fields"] == ["lr"]
    env = make_pixel_env("pendulum")
    agent = make_agent("ddpg", t_train._pipeline_encoder("miniconv4", 9,
                                                         device=CPU),
                       env.action_dim, cfg=TDDPG(**SMALL), device=CPU)
    for m in res.members:
        init = agent.init(torch.Generator().manual_seed(m.seed)).params
        assert _equal(m.params, init) == (m.overrides == {"lr": 0.0})
        assert all(torch.isfinite(x).all() for x in tree_leaves(m.params))


def test_vmap_lanes_track_exact_lanes(runs):
    """The batched lanes draw what the exact lanes draw: returns agree to
    rounding, and the trained parameters within Adam's step size."""
    for e, v in zip(runs["exact"].members, runs["vmap"].members):
        r_e = e.episode_returns + e.truncated_returns
        r_v = v.episode_returns + v.truncated_returns
        np.testing.assert_allclose(r_v, r_e, rtol=1e-4)
        err = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(e.params),
                                  tree_leaves(v.params)))
        assert err <= 2 * TDDPG().lr


def test_exact_member0_bitwise_equals_train_ppo():
    spec = t_pop.PopulationSpec(tasks=("walker",), seeds=(0, 1),
                                total_steps=16, cfg_overrides=PPO_SMALL)
    res = t_pop.train_population(spec, eval_episodes=0, device=CPU)
    single = t_train.train("walker", "miniconv4", total_steps=16, seed=0,
                           cfg=TPPO(**PPO_SMALL), device=CPU)
    assert _equal(res.members[0].params, single.params)
    assert res.members[0].truncated_returns == single.truncated_returns
    assert not _equal(res.members[1].params, single.params)


def test_population_result_and_program_stats(runs):
    for mode in t_pop.LANE_MODES:
        res = runs[mode]
        assert all(m.eval_returns is not None and m.eval_returns.shape == (4,)
                   for m in res.members)
        assert all(np.isfinite(m.final_100_mean) for m in res.members)
        best = res.best_member()
        assert best.final_100_mean == max(m.final_100_mean
                                          for m in res.members)
        summ = res.summary()
        assert summ["best_member"] == best.index
        assert summ["n_members"] == 4 and summ["n_programs"] == 1
        stats = summ["programs"][0]
        assert {"task", "algo", "n_members", "hyper_fields",
                "env_steps_per_member", "wall_s", "compile_s"} <= set(stats)
        assert stats["lane_mode"] == mode
        assert 0 < stats["compile_s"] <= stats["wall_s"]
        assert res.aggregate_steps_per_sec > 0
        # the program's engine, its final carry and its phases
        (run,) = res.runs
        assert run.engine.lane_mode == mode and run.engine.n_members == 4
        assert [p for p, _, _ in run.phases] == run.engine.plan()
        losses = [v for _, _, m in run.phases for v in m.values()]
        assert losses and all(v.shape == (4,) and torch.isfinite(v).all()
                              for v in losses)
        assert _equal(run.engine.state(run.carry).params,
                      t_pop.stack_trees([m.params for m in res.members]))
    # train_population is exported where the reference exports it
    from repro_torch import rl
    assert rl.train_population is t_train.train_population


def test_engine_refusals():
    env = make_pixel_env("pendulum")
    enc = t_train._pipeline_encoder("miniconv4", 9, device=CPU)
    with pytest.raises(ValueError, match="lane_mode"):
        t_pop.make_population_engine(env, "ddpg", enc, 1, TDDPG(**SMALL), {},
                                     2, 16, lane_mode="scan", device=CPU)
    with pytest.raises(ValueError, match="2 values"):
        t_pop.make_population_engine(env, "ddpg", enc, 1, TDDPG(**SMALL),
                                     {"lr": [1e-3]}, 2, 16, device=CPU)
    eng = t_pop.make_population_engine(env, "ddpg", enc, 1, TDDPG(**SMALL),
                                       {}, 2, 16, device=CPU)
    with pytest.raises(ValueError, match="2 members"):
        eng.init([0])


# ---------------------------------------------------- one update a lane
def _agents(algo, cfg_cls_j, cfg_cls_t, kw, action_dim, lrs):
    jenc = JDeployment.build(JConfig.from_encoder_name(
        "miniconv4", c_in=9, h=H, backend="xla")).encoder
    tenc = Deployment.build(DeploymentConfig.from_encoder_name(
        "miniconv4", c_in=9, h=H, backend="xla"), device=CPU).encoder
    tcfg = cfg_cls_t(**kw)
    members = [make_agent(algo, tenc, action_dim, device=CPU,
                          cfg=dataclasses.replace(tcfg, lr=lr))
               for lr in lrs]
    lanes = t_pop.BatchedLanes(algo, tenc, action_dim, tcfg, {"lr": lrs},
                               device=CPU)
    return jenc, cfg_cls_j(**kw), members, lanes


def _stacked_reference_state(jenc, algo, jcfg, members, action_dim):
    """The reference's member-stacked TrainState holding the port's
    initial parameters (seeds 0, 1, 2) and a zero Adam state; its
    structure and shapes are what the reference's vmapped ``init``
    returns."""
    from repro.rl.agent import TrainState as JTrainState
    states = [a.init(torch.Generator().manual_seed(p))
              for p, a in enumerate(members)]
    to_j = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(x.numpy()), t)
    stacked = t_pop.stack_trees(states)
    params = to_j(stacked.params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jstate = JTrainState(params, to_j(stacked.target),
                         j_opt.OptState(jnp.zeros((3,), jnp.int32), zeros,
                                        zeros))
    jagent = j_make_agent(algo, jenc, action_dim, cfg=jcfg)
    keys = jnp.stack([jax.random.PRNGKey(p) for p in range(3)])
    want = jax.eval_shape(jax.vmap(jagent.init), keys)
    assert jax.tree.structure(jstate) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    return jstate


def _reference_update(jenc, algo, jcfg, action_dim):
    """The reference population's per-member update body, its lr a
    traced hyperparameter as the reference's engine rebuilds it."""
    def upd(state, data, key, lr):
        agent = j_make_agent(algo, jenc, action_dim,
                             cfg=dataclasses.replace(jcfg, lr=lr))
        state, metrics = agent.update(state, data, key)
        return agent.target_update(state), metrics
    return upd


def _data(algo, rng, P, A, kw):
    if algo == "ppo":
        T, N = kw["n_steps"], kw["n_envs"]
        return {"traj": {
            "obs": rng.random((P, T, N, H, H, 9)).astype(np.float32),
            "action": rng.standard_normal((P, T, N, A)).astype(np.float32),
            "reward": rng.standard_normal((P, T, N)).astype(np.float32),
            "done": rng.random((P, T, N)) < 0.2,
            "logp": (rng.standard_normal((P, T, N)) - 5).astype(np.float32),
            "value": rng.standard_normal((P, T, N)).astype(np.float32)},
            "last_obs": rng.random((P, N, H, H, 9)).astype(np.float32)}
    B = kw["batch_size"]
    return {"obs": rng.random((P, B, H, H, 9)).astype(np.float32),
            "next_obs": rng.random((P, B, H, H, 9)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (P, B, A)).astype(np.float32),
            "rewards": rng.standard_normal((P, B)).astype(np.float32),
            "dones": (rng.random((P, B)) < 0.3).astype(np.float32)}


def _reference_draws(algo, key, kw, A):
    """What the reference's update draws from ``key``, for the port's
    ``noise=``: SAC's two normals, PPO's permutations."""
    if algo == "sac":
        k1, k2 = jax.random.split(key)
        return tuple(_t(jax.random.normal(k, (kw["batch_size"], A)))
                     for k in (k1, k2))
    if algo == "ppo":
        n = kw["n_steps"] * kw["n_envs"]
        return torch.stack([_t(jax.random.permutation(k, n)) for k in
                            jax.random.split(key, kw["n_epochs"])])
    return None


def _close(want, got, lr, tau, grad_rtol, loss_rtol, what):
    """One update's state and metrics: losses, gradients (from the first
    moment), parameters within 2 lr, targets within 4 lr tau."""
    (ws, wm), (gs, gm) = want, got
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=loss_rtol, atol=1e-5,
                                   err_msg=f"{what}: {k}")
    for w, g in zip(ws["mu"], gs["mu"]):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= grad_rtol * scale, what
    for w, g in zip(ws["params"], gs["params"]):
        assert float(np.abs(g - w).max()) <= 2 * lr, what
    for w, g in zip(ws["target"], gs["target"]):
        assert float(np.abs(g - w).max()) <= 4 * lr * tau + 1e-7, what


def _as_np(state, metrics, p=None):
    """(state, metrics) of one update as numpy leaves, member ``p`` of a
    stacked one; the reference's or the port's."""
    def pick(x):
        x = x.detach().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        return x if p is None else x[p]

    def leaves(t):
        return [pick(x) for x in (tree_leaves(t) if isinstance(
            tree_leaves(t)[0], torch.Tensor) else jax.tree.leaves(t))] \
            if jax.tree.leaves(t) else []

    return ({"params": leaves(state.params), "target": leaves(state.target),
             "mu": leaves(state.opt_state.mu)},
            {k: pick(v) for k, v in metrics.items()})


UPDATES = {
    "ddpg": (JDDPG, TDDPG, {"batch_size": 16}, 1, [1e-3, 3e-4, 0.0]),
    "sac": (JSAC, TSAC, {"batch_size": 16}, 3, [3e-4, 1e-3, 0.0]),
    "ppo": (JPPO, TPPO, {"n_envs": 2, "n_steps": 8, "n_epochs": 1,
                         "n_minibatches": 1}, 6, [3e-4, 1e-3, 0.0]),
}


@pytest.mark.parametrize("algo", list(UPDATES))
def test_one_update_each_lane_mode_against_reference(algo):
    """P=3 members (an ``lr`` column with a 0) take one update from the
    reference's stacked TrainState on fixed batches with the reference's
    draws: the reference's exact lanes (each member alone) and vmap lanes
    against the port's."""
    jcls, tcls, kw, A, lrs = UPDATES[algo]
    jenc, jcfg, members, lanes = _agents(algo, jcls, tcls, kw, A, lrs)
    jstate = _stacked_reference_state(jenc, algo, jcfg, members, A)
    tstate = stacked_train_state_from_jax(jstate, CPU)
    assert tstate.opt_state.step.shape == (3,)
    data = _data(algo, np.random.default_rng(5), 3, A, kw)
    keys = jnp.stack([jax.random.PRNGKey(7 + p) for p in range(3)])
    jdata = jax.tree.map(jnp.asarray, data)
    upd = _reference_update(jenc, algo, jcfg, A)
    jlr = jnp.asarray(lrs, jnp.float32)

    # the reference: each member alone, and the members batched
    one = jax.jit(upd)
    j_exact = [one(jax.tree.map(lambda x: x[p], jstate),
                   jax.tree.map(lambda x: x[p], jdata), keys[p], jlr[p])
               for p in range(3)]
    j_vmap = jax.jit(jax.vmap(upd))(jstate, jdata, keys, jlr)

    # the port: each member alone, and the batched lanes, on those draws
    tdata = jax.tree.map(_t, data)
    noise = [_reference_draws(algo, keys[p], kw, A) for p in range(3)]
    t_exact = []
    for p, agent in enumerate(members):
        s, m = agent.update(t_pop.member_tree(tstate, p),
                            t_pop.member_tree(tdata, p), noise=noise[p])
        t_exact.append((agent.target_update(s), m))
    t_vmap = lanes.update(tstate, tdata, t_pop.stack_trees(noise))

    tau = getattr(members[0].cfg, "tau", 0.0)
    for p, lr in enumerate(lrs):
        je, te = _as_np(*j_exact[p]), _as_np(*t_exact[p])
        jv, tv = _as_np(*j_vmap, p), _as_np(*t_vmap, p)
        _close(je, te, lr, tau, GRAD_RTOL, 1e-4, f"exact member {p}")
        _close(jv, tv, lr, tau, GRAD_RTOL, 1e-4, f"vmap member {p}")
        _close(te, tv, lr, tau, LANE_RTOL, LANE_RTOL,
               f"port vmap vs exact member {p}")
        if lr == 0.0:
            init = [x[p].numpy() for x in tree_leaves(tstate.params)]
            for side in (je, te, jv, tv):
                for w, g in zip(init, side[0]["params"]):
                    np.testing.assert_array_equal(g, w)
    assert [int(s) for s in t_vmap[0].opt_state.step] == [1, 1, 1]


@pytest.mark.parametrize("algo", list(UPDATES))
def test_batched_lanes_have_no_vmap_fallbacks(algo):
    """Every VMAPPABLE field a per-member column (each member's value a
    0-d tensor inside the vmap): every op of the batched act and update
    has a batching rule — none runs functorch's per-member loop, which the
    counter does see — and each member's act and losses are its own
    config's, within the lanes' tolerance."""
    _, tcls, kw, A, _ = UPDATES[algo]
    tenc = Deployment.build(DeploymentConfig.from_encoder_name(
        "miniconv4", c_in=9, h=H, backend="xla"), device=CPU).encoder
    cfg = tcls(**kw)
    hyper = {k: [getattr(cfg, k), 0.5 * getattr(cfg, k)]
             for k in sorted(tcls.VMAPPABLE)}
    lanes = t_pop.BatchedLanes(algo, tenc, A, cfg, hyper, device=CPU)
    state = t_pop.stack_trees([lanes.agent.init(
        torch.Generator().manual_seed(p)) for p in range(2)])
    data = jax.tree.map(_t, _data(algo, np.random.default_rng(6), 2, A, kw))
    gens = [torch.Generator().manual_seed(p) for p in range(2)]
    obs = data["traj"]["obs"][:, 0] if algo == "ppo" else data["obs"]
    act_noise = lanes.act_noise(gens, obs.shape[1])
    upd_noise = lanes.update_noise(gens, data)
    with t_pop.vmap_fallbacks() as found:
        action, _ = lanes.act(state.params, obs, act_noise)
        new, metrics = lanes.update(state, data, upd_noise)
    assert found == []
    assert action.shape == (2, obs.shape[1], A)
    for p in range(2):
        agent = make_agent(algo, tenc, A, device=CPU,
                           cfg=dataclasses.replace(
                               cfg, **{k: v[p] for k, v in hyper.items()}))
        want, _ = agent.act(t_pop.member_tree(state.params, p), obs[p],
                            noise=act_noise[p])
        np.testing.assert_allclose(action[p].numpy(), want.numpy(),
                                   rtol=LANE_RTOL, atol=1e-6)
        _, want_m = agent.update(t_pop.member_tree(state, p),
                                 t_pop.member_tree(data, p),
                                 noise=t_pop.member_tree(upd_noise, p))
        for k, v in want_m.items():
            np.testing.assert_allclose(metrics[k][p].numpy(), v.numpy(),
                                       rtol=LANE_RTOL, atol=1e-5)
    with t_pop.vmap_fallbacks() as planted:
        torch.func.vmap(lambda x: torch.histc(x, bins=4))(torch.rand(3, 5))
    assert len(planted) == 1 and "aten::histc" in planted[0]


def test_stacked_converter_refuses_an_unstacked_state():
    from repro.rl.agent import TrainState as JTrainState
    p = {"w": np.zeros((3, 2), np.float32)}
    ok = JTrainState(p, {}, j_opt.OptState(np.zeros(3, np.int32), p, p))
    assert stacked_train_state_from_jax(ok, CPU).params["w"].shape == (3, 2)
    bad = JTrainState(p, {}, j_opt.OptState(np.int32(0), p, p))
    with pytest.raises(ValueError, match="member-stacked"):
        stacked_train_state_from_jax(bad, CPU)


def test_optimizer_under_vmap_is_per_member():
    """Adam with clipping under ``torch.func.vmap`` on stacked trees: each
    member clipped by its own norm, with its own ``lr``; within 2 ulp of
    the member's own multi-tensor update (the norm sums in another
    order)."""
    rng = np.random.default_rng(3)
    P = 3
    tree = {"a": rng.standard_normal((P, 5, 4)).astype(np.float32),
            "b": {"k": rng.standard_normal((P, 7)).astype(np.float32)}}
    # member 1's gradients are large: only its clip may bind
    grads = {"a": rng.standard_normal((P, 5, 4)).astype(np.float32),
             "b": {"k": rng.standard_normal((P, 7)).astype(np.float32)}}
    grads["a"][1] *= 100
    lrs = torch.tensor([1e-3, 3e-4, 0.0])
    params = params_from_jax(tree, CPU)
    g = params_from_jax(grads, CPU)

    def one(p, g, lr):
        opt = t_opt.adam(lr, clip_norm=1.0)
        return opt.update(p, opt.init(p), g)

    got_p, got_s = torch.func.vmap(one)(params, g, lrs)
    norms = torch.func.vmap(t_opt.global_norm)(g)
    clipped = torch.func.vmap(lambda g: t_opt.clip_by_global_norm(g, 1.0))(g)
    for m in range(P):
        mp = t_pop.member_tree(params, m)
        mg = t_pop.member_tree(g, m)
        for w, x in zip(tree_leaves(t_opt.clip_by_global_norm(mg, 1.0)),
                        tree_leaves(t_pop.member_tree(clipped, m))):
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-9)
        opt = t_opt.adam(float(lrs[m]), clip_norm=1.0)
        want_p, want_s = opt.update(mp, opt.init(mp), mg)
        assert float(norms[m]) == pytest.approx(
            float(t_opt.global_norm(mg)), rel=1e-6)
        for w, x in zip(tree_leaves(want_p), tree_leaves(
                t_pop.member_tree(got_p, m))):
            assert np.abs(w.numpy().view(np.int32).astype(np.int64)
                          - x.numpy().view(np.int32)).max() <= 2
        for w, x in zip(tree_leaves(want_s.mu), tree_leaves(
                t_pop.member_tree(got_s.mu, m))):
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-9)
    assert torch.equal(got_p["a"][2], params["a"][2])     # lr = 0


# ---------------------------------------------------------- eval protocol
@pytest.fixture(scope="module")
def eval_setup():
    env = make_pixel_env("pendulum", train=False)
    agent = make_agent("ddpg", t_train._pipeline_encoder("miniconv4", 9,
                                                         device=CPU),
                       env.action_dim, device=CPU)
    params = [agent.init(torch.Generator().manual_seed(s)).params
              for s in (0, 1, 2)]
    return env, agent, params


def test_evaluate_replays_bitwise(eval_setup):
    env, agent, params = eval_setup
    r1 = t_pop.evaluate(agent, params[0], 4, env=env, seed=5, max_steps=8)
    r2 = t_pop.evaluate(agent, params[0], 4, env=env, seed=5, max_steps=8)
    assert r1.shape == (4,) and np.array_equal(r1, r2)
    r3 = t_pop.evaluate(agent, params[0], 4, env=env, seed=6, max_steps=8)
    assert not np.array_equal(r1, r3)
    with pytest.raises(ValueError, match="env= or task="):
        t_pop.evaluate(agent, params[0], 4)
    r4 = t_pop.evaluate(agent, params[0], 4, task="pendulum", seed=5,
                        max_steps=8)
    assert np.array_equal(r1, r4)


@pytest.mark.parametrize("mode", ["exact", "vmap"])
def test_population_evaluator_rows_and_permutation(eval_setup, mode):
    """Every member is scored on the same episodes: exact rows equal the
    single evaluator's, vmap rows within 1e-5 of them, and permuting the
    members permutes the rows bitwise."""
    env, agent, params = eval_setup
    stack = t_pop.stack_trees
    pop_eval = t_pop.make_population_evaluator(env, agent, 3, max_steps=8,
                                               lane_mode=mode)
    fwd = pop_eval(stack(params), 2).numpy()
    rev = pop_eval(stack(params[::-1]), 2).numpy()
    assert fwd.shape == (3, 3)
    np.testing.assert_array_equal(fwd[::-1], rev)
    single = t_pop.make_evaluator(env, agent, 3, max_steps=8)
    for p in range(3):
        want = single(params[p], 2).numpy()
        if mode == "exact":
            np.testing.assert_array_equal(fwd[p], want)
        else:
            np.testing.assert_allclose(fwd[p], want, rtol=LANE_RTOL)
    with pytest.raises(ValueError, match="lane_mode"):
        t_pop.make_population_evaluator(env, agent, 3, lane_mode="scan")


def test_evaluator_matches_reference(eval_setup):
    """The protocol's episode loop against the reference's
    ``_episode_returns_fn`` from the reference's initial states, on the
    port's parameters carried into the reference: 20 steps of 4
    episodes."""
    env, agent, params = eval_setup
    jenv = j_make_pixel_env("pendulum", train=False)
    jenc = JDeployment.build(JConfig.from_encoder_name(
        "miniconv4", c_in=9, backend="xla")).encoder
    jagent = j_make_agent("ddpg", jenc, 1)
    jparams = jax.tree.map(lambda x: jnp.asarray(x.numpy()), params[1])
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(j_pop._episode_returns_fn(jenv, jagent, 4,
                                                        20))(jparams, key))
    jstates, jobs = jenv.reset_batch(jax.random.split(key, 4))
    inner_cls = type(env.env.reset(torch.Generator(), 1))
    states = t_wrappers.PixelEnvState(
        inner_cls(*(_t(x) for x in jstates.inner)), _t(jstates.frames),
        torch.Generator().manual_seed(0), _t(jstates.episode_return),
        _t(jstates.step_count))
    head = agent.policy_head(params[1])
    with torch.no_grad():
        got = t_pop._episode_loop(
            lambda o: head(agent.encoder.apply(params[1]["encoder"], o)),
            states, _t(jobs), env.step_batch, 20).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= EVAL_RTOL * scale


# ------------------------------------------------------------ export_best
def test_export_best_serves_the_winner_and_its_fallbacks(eval_setup):
    env, agent, params = eval_setup
    cfg = DeploymentConfig.from_encoder_name("miniconv4", c_in=9,
                                             backend="xla")
    dep = Deployment.build(cfg, device=CPU)
    spec = t_pop.PopulationSpec(tasks="pendulum", seeds=(0, 1, 2))

    def result(mod, evals):
        members = mod.PopulationSpec(tasks="pendulum",
                                     seeds=(0, 1, 2)).members()
        for m, e, p in zip(members, evals, params):
            m.eval_returns = None if e is None else np.asarray(e)
            m.params = p
        return mod.PopulationResult(spec=spec, members=members,
                                    program_stats=[], wall_time_s=1.0)

    nan = float("nan")
    for evals, winner in ((([1.0], [3.0], [2.0]), 1),
                          (([nan], [2.0], [2.0]), 1),     # tie: lowest
                          (([nan], [nan], [nan]), 0),     # all NaN
                          (([5.0, nan], [4.0], [1.0]), 1)):
        t_res, j_res = result(t_pop, evals), result(j_pop, evals)
        assert t_res.best_member().index == j_res.best_member().index \
            == winner
        assert t_res.best_params() is params[winner]
    _, obs = env.reset_batch(torch.Generator().manual_seed(0), 1)
    res = result(t_pop, ([1.0], [3.0], [2.0]))
    head = agent.policy_head(res.best_params())
    client, server = dep.export_best(res, head=head)
    want_c, want_s = dep.serving_pair(params[1], head=head)
    got = server.serve([client.encode_fn(obs)])[0]
    want = want_s.serve([want_c.encode_fn(obs)])[0]
    assert got.shape == (1,) and torch.equal(got, want)
