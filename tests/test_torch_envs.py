"""The port's batched envs and pixel wrapper against the reference
(``repro.envs``), on the CPU.

The reference writes one env and ``jax.vmap``s it; the port writes every
function over a leading env axis.  Tolerances, with the largest error
measured when they were set:

* dynamics: states and rewards within 1e-5 (relative and absolute) over
  50 steps from converted reference states, dones equal (measured 1.0e-5
  on pendulum's unbounded angle, 1e-6 elsewhere: ``sin``/``cos`` round
  differently);
* frames from equal states: equal except boundary pixels, whose distance
  to a shape equals its radius to within rounding (``linspace`` and
  ``sin``/``cos`` differ by an ulp), at most 0.5% of a frame's pixels
  (measured 0);
* the crop, the frame stack, the auto-reset and the RGBA boundary:
  bitwise.

The reference's keys and the port's generators never agree, so the
port's step takes the reference's crop offsets and reset states
(``offsets=``, ``reset_inner=``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.envs import REGISTRY as J_REGISTRY
from repro.envs import pendulum as j_pendulum
from repro.envs import wrappers as j_wrappers
from repro_torch.envs import REGISTRY as T_REGISTRY
from repro_torch.envs import make_pixel_env
from repro_torch.envs import pendulum as t_pendulum
from repro_torch.envs import wrappers as t_wrappers

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

TASKS = ["pendulum", "hopper", "walker"]
N = 4
DYN_TOL = 1e-5
BOUNDARY_SHARE = 0.005


def _to_port(jstate, task):
    cls = type(T_REGISTRY[task].reset(torch.Generator(), 1))
    return cls(*(torch.from_numpy(np.array(x)) for x in jstate))


def _boundary_pixels(want, got):
    """Pixels (of each frame) where any channel differs."""
    diff = np.abs(np.asarray(want) - np.asarray(got)).max(-1) > 0
    return diff.reshape(diff.shape[0], -1).sum(-1)


def _reference_draws(key):
    """What the reference's ``PixelEnv.step`` draws from an env's key: the
    crop offsets (oy, ox) and the reset state's key."""
    k_crop, k_reset, _ = jax.random.split(key, 3)
    ox = jax.random.randint(k_crop, (), 0, 17)
    oy = jax.random.randint(jax.random.fold_in(k_crop, 1), (), 0, 17)
    return jnp.stack([oy, ox]), k_reset


@pytest.mark.parametrize("task", TASKS)
def test_dynamics_and_frames_match_reference(task):
    jenv, tenv = J_REGISTRY[task], T_REGISTRY[task]
    jstate = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(3), N))
    tstate = _to_port(jstate, task)
    step = jax.jit(jax.vmap(jenv.step))
    render = jax.jit(jax.vmap(jenv.render))
    rng = np.random.default_rng(0)
    worst = 0
    for k in range(50):
        a = rng.uniform(-1.2, 1.2, (N, tenv.action_dim)).astype(np.float32)
        jstate, jr, jd = step(jstate, jnp.asarray(a))
        tstate, tr, td = tenv.step(tstate, torch.from_numpy(a))
        for want, got in zip(jstate, tstate):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=DYN_TOL, atol=DYN_TOL)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=DYN_TOL,
                                   atol=DYN_TOL)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        if k % 10 == 9:
            # frames from equal (converted) states
            frames = tenv.render(_to_port(jstate, task))
            assert frames.shape == (N, 100, 100, 3)
            worst = max(worst, int(_boundary_pixels(render(jstate),
                                                    frames).max()))
    assert worst <= BOUNDARY_SHARE * 100 * 100


@pytest.mark.parametrize("task", TASKS)
def test_window_render_equals_crop_of_full_frame(task):
    tenv = T_REGISTRY[task]
    state = tenv.reset(torch.Generator().manual_seed(0), N)
    oy = torch.tensor([0, 16, 3, 8])
    ox = torch.tensor([16, 0, 7, 8])
    full = tenv.render(state)
    window = tenv.render(state, (oy, ox, 84))
    assert window.shape == (N, 84, 84, 3)
    assert torch.equal(t_wrappers.crop(full, oy, ox), window)


def test_crop_at_injected_offsets_matches_reference():
    frame = np.random.default_rng(1).random((N, 100, 100, 3)).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    want = jax.vmap(lambda f, k: j_wrappers._crop(f, k, train=True))(
        jnp.asarray(frame), keys)
    # _crop draws (ox, oy) from the key it is given
    offs = jax.vmap(lambda k: jnp.stack([
        jax.random.randint(jax.random.fold_in(k, 1), (), 0, 17),
        jax.random.randint(k, (), 0, 17)]))(keys)
    got = t_wrappers.crop(torch.from_numpy(frame),
                          torch.from_numpy(np.array(offs[:, 0])),
                          torch.from_numpy(np.array(offs[:, 1])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # eval: the centre crop
    env = make_pixel_env("pendulum", train=False)
    assert env.offsets(torch.Generator(), 2).tolist() == [[8, 8], [8, 8]]


def _pixel_pair(task):
    jenv = j_wrappers.make_pixel_env(task, train=True)
    tenv = make_pixel_env(task, train=True)
    jstates, jobs = _jitted(jenv)[2](jax.random.split(jax.random.PRNGKey(1),
                                                      N))
    tstates = t_wrappers.PixelEnvState(
        _to_port(jstates.inner, task), torch.from_numpy(np.array(
            jstates.frames)), torch.Generator(),
        torch.from_numpy(np.array(jstates.episode_return)),
        torch.from_numpy(np.array(jstates.step_count)))
    return jenv, tenv, jstates, jobs, tstates


_JIT = {}


def _jitted(jenv):
    """(step_batch, the step's draws and reset states, reset_batch),
    compiled once per reference env."""
    name = jenv.env.name
    if name not in _JIT:
        def draws(keys):
            offs, k_reset = jax.vmap(_reference_draws)(keys)
            return offs, jax.vmap(jenv.env.reset)(k_reset)
        _JIT[name] = (jax.jit(jenv.step_batch), jax.jit(draws),
                      jax.jit(jenv.reset_batch))
    return _JIT[name]


def _step_both(jenv, tenv, task, jstates, tstates, actions):
    step_batch, draws, _ = _jitted(jenv)
    offs, reset = draws(jstates.key)
    reset_inner = _to_port(reset, task)
    jstates, jobs, jr, jd = step_batch(jstates, jnp.asarray(actions))
    tstates, tobs, tr, td = tenv.step_batch(
        tstates, torch.from_numpy(actions),
        offsets=torch.from_numpy(np.array(offs)), reset_inner=reset_inner)
    return jstates, jobs, jr, jd, tstates, tobs, tr, td


@pytest.mark.parametrize("task", TASKS)
def test_frame_stack_matches_reference(task):
    jenv, tenv, jstates, jobs, tstates = _pixel_pair(task)
    tobs = t_wrappers._obs(tstates.frames)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.default_rng(2)
    prev = tobs
    for _ in range(4):
        a = rng.uniform(-1, 1, (N, tenv.action_dim)).astype(np.float32)
        jstates, jobs, jr, jd, tstates, tobs, tr, td = _step_both(
            jenv, tenv, task, jstates, tstates, a)
        assert tobs.shape == (N, 84, 84, 9) and tobs.dtype == torch.float32
        assert int(_boundary_pixels(np.asarray(jobs).reshape(
            N, 84, 84, 3, 3).transpose(0, 3, 1, 2, 4).reshape(-1, 84, 84, 3),
            tobs.numpy().reshape(N, 84, 84, 3, 3).transpose(
                0, 3, 1, 2, 4).reshape(-1, 84, 84, 3)).max()) \
            <= BOUNDARY_SHARE * 84 * 84
        # the stack shifts: the newest frame is last, the oldest dropped
        assert torch.equal(tobs[..., :6][~td], prev[..., 3:][~td])
        prev = tobs
        np.testing.assert_allclose(tstates.episode_return.numpy(),
                                   np.asarray(jstates.episode_return),
                                   rtol=DYN_TOL, atol=DYN_TOL)
        np.testing.assert_array_equal(tstates.step_count.numpy(),
                                      np.asarray(jstates.step_count))


def test_auto_reset_matches_reference():
    """Pendulum's episodes end at t = 200: from states at t = 199 every
    env resets, its stack filled with the reset frame, its return and
    step count zeroed."""
    task = "pendulum"
    jenv, tenv, jstates, _, tstates = _pixel_pair(task)
    jstates = jstates._replace(inner=jstates.inner._replace(
        t=jnp.full((N,), 199, jnp.int32)))
    tstates = tstates._replace(inner=tstates.inner._replace(
        t=torch.full((N,), 199, dtype=torch.int32)))
    a = np.zeros((N, 1), np.float32)
    reset_inner = _to_port(_jitted(jenv)[1](jstates.key)[1], task)
    jstates, jobs, jr, jd, tstates, tobs, tr, td = _step_both(
        jenv, tenv, task, jstates, tstates, a)
    assert td.all() and np.asarray(jd).all()
    for want, got, reset in zip(jstates.inner, tstates.inner, reset_inner):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, reset)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    assert torch.equal(tobs[..., :3], tobs[..., 6:])
    assert not tstates.episode_return.any() and not tstates.step_count.any()


def test_rgba_uint8_boundary_matches_reference():
    obs = np.random.default_rng(3).random((2, 84, 84, 9)).astype(np.float32)
    obs[0, 0, 0, :3] = [0.5 / 255, 1.5 / 255, 254.5 / 255]   # ties
    want = np.stack([np.asarray(j_wrappers.PixelEnv.to_rgba_uint8(
        jnp.asarray(o))) for o in obs])
    got = t_wrappers.PixelEnv.to_rgba_uint8(torch.from_numpy(obs))
    assert got.dtype == torch.uint8 and got.shape == (2, 84, 84, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.reshape(2, 84, 84, 3, 4)[..., 3].min()) == 255


def test_reset_batch_draws_from_the_generator():
    env = make_pixel_env("walker")
    s1, o1 = env.reset_batch(torch.Generator().manual_seed(4), 3)
    s2, o2 = env.reset_batch(torch.Generator().manual_seed(4), 3)
    assert o1.shape == (3, 84, 84, 9) and torch.equal(o1, o2)
    assert float(o1.min()) >= 0.0 and float(o1.max()) <= 1.0
    assert s1.inner.leg_angle.shape == (3, 2)
    assert s1.step_count.dtype == torch.int32
    # the three stacked frames of a fresh env are one frame
    assert torch.equal(o1[..., :3], o1[..., 3:6])
    s3, o3, r, d = env.step_batch(s1, torch.zeros(3, 6))
    assert r.shape == (3,) and d.dtype == torch.bool and o3.shape == o1.shape


def test_angle_normalize_is_floor_mod():
    x = np.array([-7.5, -3.2, -0.1, 0.0, 3.2, 9.9, 40.0], np.float32)
    np.testing.assert_allclose(
        t_pendulum._angle_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(j_pendulum._angle_normalize(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
