"""The port's optimizer, sampler, GAE, replay ring and one update of each
algorithm against the reference (``repro.train.optimizer``,
``repro.rl``), on the CPU.

Tolerances, each with the largest error measured when it was set:

* the optimizer alone on identical gradients: one step within 1 ulp at
  the scale of its terms (XLA fuses ``b * m + (1 - b) * g`` into one
  multiply-add on the CPU, the port rounds twice), 3 with clipping; 40
  steps within 4 ulp on the parameters;
* gradients, read from the first Adam moment after one update from the
  reference's own optimizer state (``mu = 0.1 * g``): 1e-4 relative to the
  largest element of each leaf;
* parameters after one update: ``2 * lr`` absolutely — Adam's first step
  is about ``lr * sign(g)``, so a gradient element that is zero up to
  rounding can move a parameter by ``lr`` either way; PPO's update is
  ``n_epochs * n_minibatches`` Adam steps, each within the same bound;
* the replay ring: bitwise.

The two frameworks' generators never agree, so every update here takes
the reference's own draws (``noise=``) and starts, on both sides, from
one TrainState in the reference's tree types, carried into the port by
``train_state_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.deploy import Deployment as JDeployment
from repro.deploy import DeploymentConfig as JConfig
from repro.rl import buffers as j_buffers
from repro.rl import networks as j_networks
from repro.rl.agent import make_agent as j_make_agent
from repro.rl.ddpg import DDPGConfig as JDDPG
from repro.rl.ppo import PPOConfig as JPPO
from repro.rl.sac import SACConfig as JSAC
from repro.train import optimizer as j_opt
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.deploy import Deployment as TDeployment
from repro_torch.deploy import DeploymentConfig as TConfig
from repro_torch.nn.module import tree_leaves
from repro_torch.rl import buffers as t_buffers
from repro_torch.rl import networks as t_networks
from repro_torch.rl.agent import make_agent as t_make_agent
from repro_torch.rl.ddpg import DDPGConfig as TDDPG
from repro_torch.rl.ppo import PPOConfig as TPPO
from repro_torch.rl.ppo import gae as t_gae
from repro_torch.rl.sac import SACConfig as TSAC
from repro_torch.train import optimizer as t_opt

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

CPU = "cpu"
H = 24          # miniconv4 at 24x24: a 3x3x4 feature map, a 36x512 projection
GRAD_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves_j(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _leaves_t(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves_t(t)]
    return [x.detach().numpy() for x in tree_leaves(tree)]


def _max_ulp(a, b):
    a = np.asarray(a, np.float32).ravel()
    b = np.asarray(b, np.float32).ravel()
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max()) if a.size else 0


def _random_tree(rng):
    return {"b": {"kernel": rng.standard_normal((5, 7)).astype(np.float32),
                  "bias": rng.standard_normal(7).astype(np.float32)},
            "a": np.float32(0.3),
            "c": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32)}}


# --------------------------------------------------------------- optimizer
def _ulps_at(want, got, scale):
    """|want - got| in ulps of float32 at the larger of ``scale`` and the
    result: XLA's CPU code contracts ``a * b + c`` into one fused
    multiply-add, the port's does not, so the two round once apart at the
    scale of the larger term."""
    scale = np.maximum(np.abs(np.asarray(scale, np.float32)), np.abs(want))
    spacing = np.spacing(scale)
    return float(np.max(np.abs(np.asarray(want, np.float64)
                               - np.asarray(got, np.float64)) / spacing))


OPTIMIZERS = [("adam", {}), ("adam", {"clip_norm": 10.0}),
              ("adam", {"clip_norm": 0.5}), ("adamw", {}),
              ("sgd", {"momentum": 0.9}), ("sgd", {"clip_norm": 0.5})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_optimizer_step_on_equal_gradients_within_one_ulp(name, kw):
    """One update from an identical mid-training state (step 5, non-zero
    moments) on identical gradients: every moment and parameter within 1
    ulp at the scale of its terms (largest measured: 1).  With clipping,
    3 (largest measured: 2.2): the global norm is one multi-tensor norm here and a sum of per-leaf
    sums there, so the clipped gradients differ by an ulp already."""
    rng = np.random.default_rng(0)
    tree = _random_tree(rng)
    like = lambda s: jax.tree.map(  # noqa: E731
        lambda x: (rng.standard_normal(np.shape(x)) * s).astype(np.float32),
        tree)
    mu = like(0.05)
    nu = jax.tree.map(np.abs, like(0.01))
    grads = like(0.1)
    jo = getattr(j_opt, name)(3e-4, **kw)
    to = getattr(t_opt, name)(3e-4, **kw)
    jstate = j_opt.OptState(jnp.asarray(5, jnp.int32),
                            jax.tree.map(jnp.asarray, mu),
                            jax.tree.map(jnp.asarray, nu))
    tstate = t_opt.OptState(torch.tensor(5, dtype=torch.int32),
                            params_from_jax(mu, CPU),
                            params_from_jax(nu, CPU))
    jp, js = jax.jit(jo.update)(jax.tree.map(jnp.asarray, tree), jstate,
                                jax.tree.map(jnp.asarray, grads))
    tp, ts = to.update(params_from_jax(tree, CPU), tstate,
                       params_from_jax(grads, CPU))
    assert int(ts.step) == int(js.step) == 6 and ts.step.dtype == torch.int32
    g = _leaves_j(grads)
    if "clip_norm" in kw:
        norm = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in g))
        g = [x * min(1.0, kw["clip_norm"] / norm) for x in g]
    m, v, p = _leaves_j(mu), _leaves_j(nu), _leaves_j(tree)
    b1, b2 = (0.9, 0.999) if name != "sgd" else (kw.get("momentum", 0.0), 1)
    scales_m = [np.maximum(np.abs(b1 * a), np.abs((1 - b1) * x) if name
                           != "sgd" else np.abs(x)) for a, x in zip(m, g)]
    scales_v = [np.maximum(np.abs(b2 * a), np.abs((1 - b2) * x * x))
                for a, x in zip(v, g)]
    tol = 3 if "clip_norm" in kw else 1
    for want, got, scale in zip(_leaves_j(js.mu), _leaves_t(ts.mu),
                                scales_m):
        assert _ulps_at(want, got, scale) <= tol
    if name != "sgd":
        for want, got, scale in zip(_leaves_j(js.nu), _leaves_t(ts.nu),
                                    scales_v):
            assert _ulps_at(want, got, scale) <= tol
    for want, got, scale in zip(_leaves_j(jp), _leaves_t(tp), p):
        assert _ulps_at(want, got, scale) <= tol


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_optimizer_trajectory_on_equal_gradients(name, kw):
    """40 updates from zero moments: the one-rounding difference above
    does not grow (parameters within 4 ulp, moments within 1e-6 of each
    leaf's largest element; largest measured: 3 ulp)."""
    rng = np.random.default_rng(0)
    tree = _random_tree(rng)
    jo = getattr(j_opt, name)(3e-4, **kw)
    to = getattr(t_opt, name)(3e-4, **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, CPU)
    js, ts = jo.init(jp), to.init(tp)
    update = jax.jit(jo.update)
    for _ in range(40):
        g = jax.tree.map(lambda x: (rng.standard_normal(np.shape(x)) * 0.1)
                         .astype(np.float32), tree)
        jp, js = update(jp, js, jax.tree.map(jnp.asarray, g))
        tp, ts = to.update(tp, ts, params_from_jax(g, CPU))
    assert int(ts.step) == int(js.step) == 40
    for want, got in zip(_leaves_j(jp), _leaves_t(tp)):
        assert want.shape == got.shape and _max_ulp(want, got) <= 4
    for want, got in zip(_leaves_j((js.mu, js.nu)), _leaves_t((ts.mu,
                                                               ts.nu))):
        assert float(np.abs(want - got).max()) <= 1e-6 * max(
            float(np.abs(want).max()), 1e-30)


def test_schedules_norm_and_ema():
    rng = np.random.default_rng(1)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    js = j_opt.cosine_schedule(1e-3, 20, 100, floor=1e-5)
    ts = t_opt.cosine_schedule(1e-3, 20, 100, floor=1e-5)
    np.testing.assert_allclose(ts(_t(steps)).numpy(),
                               np.asarray(js(jnp.asarray(steps))),
                               rtol=1e-5, atol=1e-12)
    assert t_opt.constant_schedule(3e-4)(_t(np.int32(5))) == 3e-4
    tree = _random_tree(rng)
    np.testing.assert_allclose(
        t_opt.global_norm(params_from_jax(tree, CPU)).item(),
        float(j_opt.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)
    for want, got in zip(
            _leaves_j(j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray,
                                                             tree), 1.0)),
            _leaves_t(t_opt.clip_by_global_norm(params_from_jax(tree, CPU),
                                                1.0))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    new = _random_tree(rng)
    for want, got in zip(
            _leaves_j(j_opt.ema_update(tree, new, 0.005)),
            _leaves_t(t_opt.ema_update(params_from_jax(tree, CPU),
                                       params_from_jax(new, CPU), 0.005))):
        assert _max_ulp(want, got) <= 1


# ----------------------------------------------------------------- sampler
def test_squashed_actor_sample_with_injected_eps():
    key = jax.random.PRNGKey(0)
    p = jax.jit(j_networks.squashed_actor_init, static_argnums=(1, 2))(
        key, 32, 3)
    feats = jax.random.normal(jax.random.PRNGKey(1), (16, 32)) * 3.0
    k = jax.random.PRNGKey(2)
    want = jax.jit(j_networks.squashed_actor_sample)(p, feats, k)
    eps = jax.random.normal(k, (16, 3))      # the draw the reference makes
    got = t_networks.squashed_actor_sample(params_from_jax(p, CPU),
                                           _t(feats), _t(eps))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # softplus without torch's threshold, as jax.nn.softplus
    x = torch.tensor([-40.0, -3.0, 0.0, 2.5, 25.0, 60.0])
    np.testing.assert_allclose(t_networks.softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(x.numpy())),
                               rtol=1e-6)


# --------------------------------------------------------------------- GAE
def _closure(fn, name):
    """A function the reference defines inside its agent factory."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


def test_gae_matches_reference():
    rng = np.random.default_rng(2)
    T, N = 16, 3
    traj = {"reward": rng.standard_normal((T, N)).astype(np.float32),
            "value": rng.standard_normal((T, N)).astype(np.float32),
            "done": rng.random((T, N)) < 0.2}
    last = rng.standard_normal(N).astype(np.float32)
    cfg = JPPO(n_envs=N, n_steps=T)
    enc = JDeployment.build(JConfig.from_encoder_name(
        "miniconv4", c_in=9, h=H, backend="xla")).encoder
    j_gae = _closure(j_make_agent("ppo", enc, 2, cfg=cfg).update, "gae")
    want_adv, want_ret = j_gae(jax.tree.map(jnp.asarray, traj),
                               jnp.asarray(last))
    adv, ret = t_gae({k: _t(v) for k, v in traj.items()}, _t(last),
                     cfg.gamma, cfg.gae_lambda)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- one update each
def _agents(algo, jcfg, tcfg, action_dim):
    jenc = JDeployment.build(JConfig.from_encoder_name(
        "miniconv4", c_in=9, h=H, backend="xla")).encoder
    tenc = TDeployment.build(TConfig.from_encoder_name(
        "miniconv4", c_in=9, h=H, backend="xla"), device=CPU).encoder
    return (j_make_agent(algo, jenc, action_dim, cfg=jcfg),
            t_make_agent(algo, tenc, action_dim, cfg=tcfg, device=CPU))


def _reference_state(jagent, tagent):
    """A reference TrainState holding the port's initial parameters (the
    reference's own tree types, a zero Adam state at step 0): its shapes
    and structure must be what the reference's ``init`` returns.  Cheaper
    than compiling the reference's ``init``; the update under test starts
    from ``train_state_from_jax`` of it either way."""
    from repro.rl.agent import TrainState as JTrainState
    tstate = tagent.init(torch.Generator().manual_seed(0))
    to_j = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(x.numpy()), t)
    params = to_j(tstate.params)
    zeros = jax.tree.map(jnp.zeros_like, params)
    jstate = JTrainState(params, to_j(tstate.target),
                         j_opt.OptState(jnp.zeros((), jnp.int32), zeros,
                                        zeros))
    want = jax.eval_shape(jagent.init, jax.random.PRNGKey(0))
    assert (jax.tree.structure(jstate) == jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    return jstate


def _replay_batch(rng, B, A):
    return {"obs": rng.random((B, H, H, 9)).astype(np.float32),
            "next_obs": rng.random((B, H, H, 9)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, A)).astype(np.float32),
            "rewards": rng.standard_normal(B).astype(np.float32),
            "dones": (rng.random(B) < 0.3).astype(np.float32)}


def _check_update(jstate, jnew, jm, tnew, tm, lr, n_steps):
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert int(tnew.opt_state.step) == int(jnew.opt_state.step)
    if n_steps == 1:
        # mu = (1 - b1) * g from a zero moment: the (clipped) gradients
        for path, want in jax.tree_util.tree_leaves_with_path(
                jnew.opt_state.mu):
            got = tnew.opt_state.mu
            for p in path:
                got = got[p.key]
            want = np.asarray(want)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got.numpy() - want).max())
            assert err <= GRAD_RTOL * scale, (path, err, scale)
    for want, got in zip(_leaves_j(jnew.params), _leaves_t(tnew.params)):
        assert float(np.abs(got - want).max()) <= 2 * lr * n_steps
    # the update leaves the target alone; target_update is the EMA
    for want, got in zip(_leaves_j(jnew.target), _leaves_t(tnew.target)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ["ddpg", "sac"])
def test_offpolicy_update_matches_reference(algo):
    A = 3
    jcfg, tcfg = ((JDDPG(batch_size=16), TDDPG(batch_size=16))
                  if algo == "ddpg" else
                  (JSAC(batch_size=16), TSAC(batch_size=16)))
    jagent, tagent = _agents(algo, jcfg, tcfg, A)
    jstate = _reference_state(jagent, tagent)
    tstate = train_state_from_jax(jstate, CPU)
    if algo == "sac":
        assert tstate.params["log_alpha"].dim() == 0
    batch = _replay_batch(np.random.default_rng(3), 16, A)
    key = jax.random.PRNGKey(7)
    jnew, jm = jax.jit(jagent.update)(jstate,
                                      jax.tree.map(jnp.asarray, batch), key)
    noise = None
    if algo == "sac":                 # sac.py's k1, k2 and their draws
        k1, k2 = jax.random.split(key)
        noise = tuple(_t(jax.random.normal(k, (16, A))) for k in (k1, k2))
    tnew, tm = tagent.update(tstate, {k: _t(v) for k, v in batch.items()},
                             noise=noise)
    _check_update(jstate, jnew, jm, tnew, tm, tcfg.lr, 1)
    jt, tt = jax.jit(jagent.target_update)(jnew), tagent.target_update(tnew)
    for want, got in zip(_leaves_j(jt.target), _leaves_t(tt.target)):
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * tcfg.lr
                                   * tcfg.tau)


@pytest.mark.parametrize("n_epochs,n_minibatches", [(1, 1), (2, 2)])
def test_ppo_update_matches_reference(n_epochs, n_minibatches):
    """(1, 1): one Adam step on the whole rollout, gradients compared;
    (2, 2): four steps on the reference's permutations."""
    T, N, A = 8, 2, 6
    kw = dict(n_envs=N, n_steps=T, n_epochs=n_epochs,
              n_minibatches=n_minibatches)
    jagent, tagent = _agents("ppo", JPPO(**kw), TPPO(**kw), A)
    jstate = _reference_state(jagent, tagent)
    tstate = train_state_from_jax(jstate, CPU)
    rng = np.random.default_rng(4)
    traj = {"obs": rng.random((T, N, H, H, 9)).astype(np.float32),
            "action": rng.standard_normal((T, N, A)).astype(np.float32),
            "reward": rng.standard_normal((T, N)).astype(np.float32),
            "done": rng.random((T, N)) < 0.2,
            "logp": (rng.standard_normal((T, N)) - 5).astype(np.float32),
            "value": rng.standard_normal((T, N)).astype(np.float32)}
    last_obs = rng.random((N, H, H, 9)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jnew, jm = jax.jit(jagent.update)(
        jstate, {"traj": jax.tree.map(jnp.asarray, traj),
                 "last_obs": jnp.asarray(last_obs)}, key)
    perms = torch.stack([_t(jax.random.permutation(k, T * N))
                         for k in jax.random.split(key, n_epochs)])
    tnew, tm = tagent.update(
        tstate, {"traj": {k: _t(v) for k, v in traj.items()},
                 "last_obs": _t(last_obs)}, noise=perms)
    _check_update(jstate, jnew, jm, tnew, tm, TPPO().lr,
                  n_epochs * n_minibatches)


def test_ppo_gradient_through_the_clip_tie():
    """``ratio`` is exactly 1 in PPO's first minibatch, so ``pg1 == pg2``
    in the min: both frameworks split the gradient evenly there."""
    adv = np.array([1.0, -2.0, 0.5, 3.0], np.float32)

    def jf(r):
        return -jnp.minimum(r * adv, jnp.clip(r, 0.8, 1.2) * adv).mean()

    def tf(r):
        a = torch.from_numpy(adv)
        return -torch.minimum(r * a, torch.clamp(r, 0.8, 1.2) * a).mean()

    want = np.asarray(jax.grad(jf)(jnp.ones(4)))
    got = torch.func.grad(tf)(torch.ones(4)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- the ring
def _transitions(rng, n, shape, a):
    return (rng.random((n,) + shape).astype(np.float32),
            rng.uniform(-1, 1, (n, a)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.random((n,) + shape).astype(np.float32),
            rng.random(n) < 0.3)


@pytest.mark.parametrize("n_add,cap_mult,n_batches",
                         [(1, 4, 2), (3, 4, 4), (3, 2, 7), (2, 1, 5),
                          (4, 3, 10)])
def test_device_ring_bitwise_against_numpy_reference(n_add, cap_mult,
                                                     n_batches):
    shape, A = (3, 3, 2), 2
    cap = n_add * cap_mult
    rng = np.random.default_rng(n_add * 10 + cap_mult)
    ref = j_buffers.ReplayBuffer(cap, shape, A)
    buf = t_buffers.device_buffer(cap, shape, A, n_add=n_add, device=CPU)
    for _ in range(n_batches):
        obs, act, rew, nxt, done = _transitions(rng, n_add, shape, A)
        ref.add_batch(obs, act, rew, nxt, done)
        buf = t_buffers.buffer_add(buf, _t(obs), _t(act), _t(rew), _t(nxt),
                                   _t(done))
        assert (buf.idx, buf.size) == (ref.idx, len(ref))
    for name in ("obs", "next_obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                      getattr(ref, name))
    # the port's numpy copy is the reference's
    mine = t_buffers.ReplayBuffer(cap, shape, A)
    rng = np.random.default_rng(0)
    for _ in range(n_batches):
        mine.add_batch(*_transitions(rng, n_add, shape, A))
    rng = np.random.default_rng(0)
    ref = j_buffers.ReplayBuffer(cap, shape, A)
    for _ in range(n_batches):
        ref.add_batch(*_transitions(rng, n_add, shape, A))
    np.testing.assert_array_equal(mine.sample(5)["obs"], ref.sample(5)["obs"])


def test_device_ring_sampling_and_width():
    buf = t_buffers.device_buffer(12, (2,), 1, n_add=3, device=CPU)
    with pytest.raises(ValueError, match="multiple of the insert width"):
        t_buffers.device_buffer(10, (2,), 1, n_add=3, device=CPU)
    with pytest.raises(ValueError, match="insert width 2"):
        t_buffers.buffer_add(buf, torch.zeros(2, 2), torch.zeros(2, 1),
                             torch.zeros(2), torch.zeros(2, 2),
                             torch.zeros(2, dtype=torch.bool))
    obs = torch.rand(3, 2)
    buf = t_buffers.buffer_add(buf, obs, torch.ones(3, 1), torch.arange(3.0),
                               obs, torch.tensor([True, False, True]))
    idx = t_buffers.sample_indices(torch.Generator().manual_seed(0), 64,
                                   buf.size)
    assert int(idx.min()) >= 0 and int(idx.max()) < 3
    rows = t_buffers.sample_indices(torch.Generator().manual_seed(1), 16,
                                    buf.size)
    batch = t_buffers.buffer_sample(buf, 16,
                                    torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(batch["rewards"].numpy(),
                                  rows.numpy().astype(np.float32))
    np.testing.assert_array_equal(batch["dones"].numpy(),
                                  (rows.numpy() != 1).astype(np.float32))
    want = np.asarray(j_buffers.quantize_obs(jnp.asarray(obs.numpy())))
    np.testing.assert_array_equal(t_buffers.quantize_obs(obs).numpy(), want)
    np.testing.assert_allclose(batch["obs"].numpy(),
                               want[rows.numpy()].astype(np.float32) / 255.0,
                               rtol=1e-7)
