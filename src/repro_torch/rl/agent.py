"""The unified Agent interface: ONE protocol for PPO / SAC / DDPG (port of
``repro.rl.agent``).

Every algorithm is a frozen :class:`Agent` bundle — ``init`` / ``act`` /
``update`` / ``target_update`` / ``policy_head`` plus its config — so the
training driver (``repro_torch.rl.train``), the rollout engines
(``repro_torch.rl.rollout``) and the deployment path never branch on the
algorithm name.

Contract
--------
``init(gen) -> TrainState``
    Fresh parameters on the agent's device, drawn in turn from ``gen``
    (a CPU ``torch.Generator``, so a seed gives the same parameters on any
    device), target parameters (``{}`` for on-policy agents) and optimizer
    state.
``act(params, obs, gen=None, *, noise=None) -> (action, extras)``
    The EXPLORATION policy over a leading env axis.  Every algorithm's
    exploration takes one standard-normal draw of shape ``(N,
    action_dim)``: from ``gen`` (on the device), or given as ``noise``
    (:func:`act_noise` makes it from ``gen`` the same way), so a
    population's batched lanes can draw it outside ``torch.func.vmap``.
    ``extras`` holds what an on-policy update needs stored in the
    trajectory (PPO: ``logp``/``value``).
``update(state, data, gen=None, *, noise=None) -> (state, metrics)``
    One learning step.  Off-policy: ``data`` is a replay minibatch;
    on-policy: ``{"traj": ..., "last_obs": ...}``.  The randomness an
    update uses (SAC: its two standard-normal draws; PPO: one permutation
    an epoch) is drawn from ``gen``, or given as ``noise`` in the form
    ``draw_noise(gen, data)`` returns, so a test can feed the reference's.
    Metrics are 0-d tensors on the device.
``target_update(state) -> state``
    Polyak/EMA target step, identity for agents without targets.
``policy_head(params) -> (feats -> action)``
    The deterministic serving-time policy applied AFTER the encoder —
    the ``head`` a :class:`repro_torch.deploy.Deployment` server mounts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.rl.networks import Encoder


class TrainState(NamedTuple):
    """The complete learnable state; ``target`` is ``{}`` for agents
    without target networks (PPO)."""

    params: Any
    target: Any
    opt_state: Any


@dataclasses.dataclass(frozen=True)
class Agent:
    """Frozen bundle of one RL algorithm behind the uniform protocol."""

    name: str                     # "ppo" | "sac" | "ddpg"
    cfg: Any                      # the algorithm's config dataclass
    encoder: Encoder
    action_dim: int
    on_policy: bool
    init: Callable                # (gen) -> TrainState
    act: Callable                 # (params, obs, gen=None, *, noise=None)
                                  # -> (action, extras)
    update: Callable              # (state, data, gen=None, *, noise=None)
    draw_noise: Callable          # (gen, data) -> the update's noise
    target_update: Callable       # (state) -> state
    policy_head: Callable         # (params) -> (feats -> action)

    @property
    def n_envs(self) -> int:
        return self.cfg.n_envs


def _algorithms() -> dict:
    """algo name -> (ConfigCls, agent factory), imported lazily."""
    from repro_torch.rl.ddpg import DDPGConfig, make_ddpg_agent
    from repro_torch.rl.ppo import PPOConfig, make_ppo_agent
    from repro_torch.rl.sac import SACConfig, make_sac_agent
    return {"ppo": (PPOConfig, make_ppo_agent),
            "sac": (SACConfig, make_sac_agent),
            "ddpg": (DDPGConfig, make_ddpg_agent)}


def make_agent(algo: str, encoder: Encoder, action_dim: int, *,
               cfg: Any = None, n_envs: int | None = None,
               device=None) -> Agent:
    """Construct the :class:`Agent` bundle for ``algo`` on ``device``
    (``"cuda"`` by default; it must be the encoder's).

    ``cfg`` overrides the algorithm's default config; ``n_envs`` (when
    given) overrides just the parallel-env count on top of it.
    """
    from repro_torch.device import resolve_device
    algorithms = _algorithms()
    if algo not in algorithms:
        raise ValueError(f"unknown algorithm {algo!r}; one of: "
                         f"{', '.join(algorithms)}")
    config_cls, factory = algorithms[algo]
    cfg = cfg or config_cls()
    if n_envs is not None:
        cfg = dataclasses.replace(cfg, n_envs=n_envs)
    return factory(encoder, action_dim, cfg, resolve_device(device))


def no_noise(gen, data):
    return None


def act_noise(gen, n: int, action_dim: int):
    """The standard-normal draw ``Agent.act`` makes from ``gen`` for ``n``
    observations (every algorithm's is one of shape ``(n, action_dim)``)."""
    return torch.randn((n, action_dim), generator=gen, device=gen.device)


def move_state(state: TrainState, device) -> TrainState:
    """A copy of ``state`` (params, target and optimizer state) on
    ``device``."""
    from repro_torch.nn.module import tree_map
    move = lambda t: t.to(device)  # noqa: E731
    opt = state.opt_state
    return TrainState(tree_map(move, state.params),
                      tree_map(move, state.target),
                      type(opt)(*(tree_map(move, x) for x in opt)))


__all__ = ["Agent", "TrainState", "act_noise", "make_agent", "move_state"]
