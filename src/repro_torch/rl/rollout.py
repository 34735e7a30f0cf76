"""The training loops on the device (port of ``repro.rl.rollout``).

One engine per agent family, both driven identically by
``repro_torch.rl.train``:

* **On-policy** (PPO): one call per iteration — ``n_steps`` vectorised env
  steps over ``n_envs`` envs, then the agent's whole GAE + epoch/minibatch
  update.
* **Off-policy** (SAC/DDPG): one ``run_chunk`` call runs K vectorised env
  steps, and EVERY step interleaves ``train_freq * n_envs`` gradient
  updates sampled from the :class:`~repro_torch.rl.buffers.
  DeviceReplayBuffer` in the carry — rollout, replay and learning stay on
  the device.  Warmup draws uniform actions from the device generator.

Where the reference scans a jitted body, the port runs the same body as a
Python loop of eager operations on device tensors.  A chunk reads nothing
from the device: the ring's cursor is a host int and every draw comes
from a generator on the device.  ``run`` returns the chunk's ``(T, N)``
rewards and dones on the device; the driver's copy of them is the
chunk's one transfer to the host.  Each frame is quantised once and
reused as the next transition's stored observation.

Engines expose a uniform driver protocol::

    engine = make_engine(env, agent, total_steps)
    carry = engine.init(seed)
    for phase in engine.plan():    # ("warmup"|"train"|"iter", n_vec_steps)
        carry, rewards, dones, metrics = engine.run(carry, phase)
        rewards, dones = to_host(rewards, dones)
    trained = carry.state          # TrainState

``plan`` splits the construction-time ``total_steps`` budget into
fixed-shape chunks (warmup, full chunks, a tail); the budget is fixed at
build time because the off-policy ring is sized from it.  The loop bodies
are pure builders (``offpolicy_chunk_fn``, ``onpolicy_iter_fn``, ...)
separate from the ``make_*_engine`` wrappers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.envs.wrappers import PixelEnv
from repro_torch.rl.agent import Agent, TrainState
from repro_torch.rl.buffers import (DeviceReplayBuffer, buffer_add_u8,
                                    buffer_sample, device_buffer,
                                    quantize_obs)

CHUNK = 128          # max vectorised steps per off-policy run_chunk call


class OffPolicyCarry(NamedTuple):
    state: TrainState
    buf: DeviceReplayBuffer
    env_states: Any
    obs: torch.Tensor
    obs_u8: torch.Tensor         # quantised copy of obs: each frame is
                                 # quantised ONCE and reused as the next
                                 # transition's stored observation
    gen: torch.Generator         # the device generator every draw uses


class OnPolicyCarry(NamedTuple):
    state: TrainState
    env_states: Any
    obs: torch.Tensor
    gen: torch.Generator


@dataclasses.dataclass(frozen=True)
class Engine:
    """A training loop behind the uniform driver protocol."""

    agent: Agent
    n_envs: int
    init: Callable               # (seed) -> carry
    plan: Callable               # () -> [(kind, n_vec_steps)]
    run: Callable                # (carry, phase) -> (carry, r, d, metrics),
                                 # r and d (T, N) on the device


def make_engine(env: PixelEnv, agent: Agent, total_steps: int, *,
                device=None) -> Engine:
    """The matching engine for ``agent`` (dispatches on ``on_policy``) on
    ``device`` (``"cuda"`` by default; the agent's)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if agent.on_policy:
        return make_onpolicy_engine(env, agent, total_steps, dev)
    return make_offpolicy_engine(env, agent, total_steps, dev)


def _generators(seed: int, device):
    """(CPU generator for the parameters, device generator for the envs,
    actions, replay samples and updates), both from ``seed``."""
    init_gen = torch.Generator().manual_seed(seed)
    run_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return init_gen, run_gen


def _mean_metrics(sums: dict, count: int) -> dict:
    return {k: v / count for k, v in sums.items()}


def _accumulate(sums: dict, metrics: dict) -> None:
    for k, v in metrics.items():
        sums[k] = v if k not in sums else sums[k] + v


# ---------------------------------------------------------------------------
# On-policy: rollout + whole-trajectory update per call
# ---------------------------------------------------------------------------

def onpolicy_init_fn(env: PixelEnv, agent: Agent, device) -> Callable:
    """``(seed) -> OnPolicyCarry`` — agent params + N reset envs."""
    N = agent.cfg.n_envs

    def init(seed: int) -> OnPolicyCarry:
        init_gen, gen = _generators(seed, device)
        state = agent.init(init_gen)
        env_states, obs = env.reset_batch(gen, N)
        return OnPolicyCarry(state, env_states, obs, gen)

    return init


def onpolicy_rollout(env: PixelEnv, agent: Agent, carry: OnPolicyCarry,
                     n_steps: int):
    """``n_steps`` vectorised steps of the exploration policy: (env
    states, last obs, trajectory of ``(T, N, ...)`` tensors).  Reads
    nothing from the device."""
    state, env_states, obs, gen = carry
    steps = []
    for _ in range(n_steps):
        action, extras = agent.act(state.params, obs, gen)
        env_states, next_obs, reward, done = env.step_batch(
            env_states, torch.clamp(action, -1.0, 1.0))
        steps.append(dict(obs=obs, action=action, reward=reward, done=done,
                          **extras))
        obs = next_obs
    traj = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    return env_states, obs, traj


def onpolicy_iter_fn(env: PixelEnv, agent: Agent) -> Callable:
    """``(carry) -> (carry, rewards, dones, metrics)`` body of one
    on-policy iteration (rollout + whole-trajectory update); rewards and
    dones stay on the device."""
    T = agent.cfg.n_steps

    def run_iter(carry: OnPolicyCarry):
        env_states, obs, traj = onpolicy_rollout(env, agent, carry, T)
        state, metrics = agent.update(
            carry.state, {"traj": traj, "last_obs": obs}, carry.gen)
        state = agent.target_update(state)
        return (OnPolicyCarry(state, env_states, obs, carry.gen),
                traj["reward"], traj["done"], metrics)

    return run_iter


def onpolicy_plan(cfg, total_steps: int) -> list[tuple[str, int]]:
    return [("iter", cfg.n_steps)] * max(
        total_steps // (cfg.n_steps * cfg.n_envs), 1)


def to_host(rewards, dones):
    """A chunk's one device-to-host copy: its ``(T, N)`` rewards and dones
    together, as numpy arrays."""
    both = torch.stack([rewards, dones.to(rewards.dtype)]).cpu().numpy()
    return both[0], both[1].astype(bool)


def make_onpolicy_engine(env: PixelEnv, agent: Agent, total_steps: int,
                         device) -> Engine:
    cfg = agent.cfg
    init = onpolicy_init_fn(env, agent, device)
    run_iter = onpolicy_iter_fn(env, agent)

    def plan():
        return onpolicy_plan(cfg, total_steps)

    def run(carry, phase):
        return run_iter(carry)

    return Engine(agent=agent, n_envs=cfg.n_envs, init=init, plan=plan,
                  run=run)


# ---------------------------------------------------------------------------
# Off-policy: device ring buffer + interleaved updates in one loop
# ---------------------------------------------------------------------------

def offpolicy_capacity(cfg, total_steps: int) -> int:
    """Ring capacity for a run: sized to the budget (never more than
    ``cfg.buffer_size``), rounded up to the fixed ``n_envs`` insert width
    the ring requires."""
    N = cfg.n_envs
    total_vec = -(-total_steps // N)
    cap = min(cfg.buffer_size, total_vec * N)
    cap = max(cap, cfg.batch_size, N)
    return -(-cap // N) * N


def offpolicy_plan(cfg, total_steps: int) -> list[tuple[str, int]]:
    """Warmup + fixed-shape train chunks covering ``total_steps``.

    Random warmup must bank at least one minibatch before updates start.
    """
    N = cfg.n_envs
    warmup_vec = -(-max(cfg.learning_starts, cfg.batch_size) // N)
    total_vec = -(-total_steps // N)
    warm = min(warmup_vec, total_vec)
    remaining = max(total_vec - warm, 0)
    phases = [("warmup", warm)] if warm else []
    phases += [("train", CHUNK)] * (remaining // CHUNK)
    if remaining % CHUNK:
        phases.append(("train", remaining % CHUNK))
    return phases


def offpolicy_init_fn(env: PixelEnv, agent: Agent, cap: int,
                      device) -> Callable:
    """``(seed) -> OffPolicyCarry`` — params, N reset envs, and an empty
    ring of ``cap`` transitions."""
    N = agent.cfg.n_envs

    def init(seed: int) -> OffPolicyCarry:
        init_gen, gen = _generators(seed, device)
        state = agent.init(init_gen)
        env_states, obs = env.reset_batch(gen, N)
        buf = device_buffer(cap, env.obs_shape, agent.action_dim, n_add=N,
                            device=device)
        return OffPolicyCarry(state, buf, env_states, obs,
                              quantize_obs(obs), gen)

    return init


def offpolicy_chunk_fn(env: PixelEnv, agent: Agent) -> Callable:
    """``(carry, *, n_steps, warmup) -> (carry, r, d, metrics)`` body of
    one off-policy chunk: ``n_steps`` vectorised env steps, each
    interleaving ``train_freq * n_envs`` sampled gradient updates.
    Rewards and dones come back as ``(T, N)`` tensors on the device, the
    metrics as their means over the chunk's updates."""
    cfg = agent.cfg
    N = cfg.n_envs
    n_updates = cfg.train_freq * N   # keep the seed loop's 1 update/env-step

    def run_chunk(carry: OffPolicyCarry, *, n_steps: int, warmup: bool):
        state, buf, env_states, obs, obs_u8, gen = carry
        rewards, dones, sums = [], [], {}
        for _ in range(n_steps):
            if warmup:
                action = torch.rand((N, agent.action_dim), generator=gen,
                                    device=gen.device) * 2.0 - 1.0
            else:
                action, _ = agent.act(state.params, obs, gen)
            env_states, next_obs, reward, done = env.step_batch(
                env_states, torch.clamp(action, -1.0, 1.0))
            # each frame is quantised once: this step's next_obs IS the
            # next step's stored obs
            next_u8 = quantize_obs(next_obs)
            buf = buffer_add_u8(buf, obs_u8, action, reward, next_u8, done)
            if not warmup:
                for _ in range(n_updates):
                    batch = buffer_sample(buf, cfg.batch_size, gen)
                    state, m = agent.update(state, batch, gen)
                    state = agent.target_update(state)
                    _accumulate(sums, m)
            rewards.append(reward)
            dones.append(done)
            obs, obs_u8 = next_obs, next_u8
        metrics = _mean_metrics(sums, n_steps * n_updates) if sums else {}
        return (OffPolicyCarry(state, buf, env_states, obs, obs_u8, gen),
                torch.stack(rewards), torch.stack(dones), metrics)

    return run_chunk


def make_offpolicy_engine(env: PixelEnv, agent: Agent, total_steps: int,
                          device) -> Engine:
    cfg = agent.cfg
    # the construction-time budget: warmup sizing and the ring capacity
    # are derived from it, so plan cannot take a different one without
    # silently shrinking replay coverage
    cap = offpolicy_capacity(cfg, total_steps)
    init = offpolicy_init_fn(env, agent, cap, device)
    run_chunk = offpolicy_chunk_fn(env, agent)

    def plan():
        return offpolicy_plan(cfg, total_steps)

    def run(carry, phase):
        kind, n_steps = phase
        return run_chunk(carry, n_steps=n_steps, warmup=(kind == "warmup"))

    return Engine(agent=agent, n_envs=cfg.n_envs, init=init, plan=plan,
                  run=run)


__all__ = ["CHUNK", "Engine", "OffPolicyCarry", "OnPolicyCarry",
           "make_engine", "make_onpolicy_engine", "make_offpolicy_engine",
           "onpolicy_init_fn", "onpolicy_iter_fn", "onpolicy_plan",
           "onpolicy_rollout", "offpolicy_capacity", "offpolicy_chunk_fn",
           "offpolicy_init_fn", "offpolicy_plan", "to_host"]
