"""DDPG (Lillicrap et al., 2015) — the paper's Pendulum algorithm (port of
``repro.rl.ddpg``).

Deterministic actor with Gaussian exploration noise, single Q critic,
Polyak target updates — SB3 defaults.  The encoder is trained by the
critic loss (actor gradients stop at the features), as in SAC.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, FrozenSet

import torch
from torch.func import grad_and_value

from repro_torch.nn.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.rl.agent import Agent, TrainState, act_noise, no_noise
from repro_torch.rl.networks import (FEATURE_DIM, Encoder, det_actor,
                                     det_actor_init, q_critic,
                                     q_critic_init)
from repro_torch.train.optimizer import adam, batched, ema_update


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 1e-3
    batch_size: int = 64
    buffer_size: int = 20_000
    learning_starts: int = 300
    train_freq: int = 1           # gradient steps per env step (per env)
    action_noise: float = 0.1
    # parallel envs in the vectorised engine.  Pendulum episodes are a
    # fixed 200 steps, so smoke-scale runs (512 steps) over many envs
    # would truncate every episode; 2 envs completes one per env while
    # still exercising the vectorised path (raise freely at paper scale).
    n_envs: int = 2

    # Fields that only feed arithmetic (never shapes, loop lengths or
    # buffer sizes): the ones a population may vary across its members.
    VMAPPABLE: ClassVar[FrozenSet[str]] = frozenset(
        {"gamma", "tau", "lr", "action_noise"})


def add_trees(a, b):
    """Leaf-by-leaf sum of two trees of one structure (one multi-tensor
    add; leaf by leaf under ``torch.func.vmap``, where the multi-tensor
    add has no batching rule)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if batched(la):
        return tree_unflatten(a, [x + y for x, y in zip(la, lb)])
    return tree_unflatten(a, torch._foreach_add(la, lb))


def init_ddpg(gen, encoder: Encoder, action_dim: int, device):
    params = {
        "encoder": encoder.init(gen),
        "actor": det_actor_init(gen, FEATURE_DIM, action_dim, device=device),
        "q": q_critic_init(gen, FEATURE_DIM, action_dim, device=device),
    }
    return params, tree_map(torch.clone, params)


def make_ddpg_agent(encoder: Encoder, action_dim: int, cfg: DDPGConfig,
                    device) -> Agent:
    """DDPG behind the uniform :class:`~repro_torch.rl.agent.Agent`
    protocol."""
    opt = adam(cfg.lr, clip_norm=10.0)

    def init(gen) -> TrainState:
        params, target = init_ddpg(gen, encoder, action_dim, device)
        return TrainState(params, target, opt.init(params))

    def critic_loss(params, target, batch):
        feats = encoder.apply(params["encoder"], batch["obs"])
        tfeats = encoder.apply(target["encoder"], batch["next_obs"])
        next_a = det_actor(target["actor"], tfeats)
        tq = q_critic(target["q"], tfeats, next_a)
        y = (batch["rewards"]
             + cfg.gamma * (1 - batch["dones"]) * tq).detach()
        q = q_critic(params["q"], feats, batch["actions"])
        return torch.square(q - y).mean()

    def actor_loss(params, batch):
        feats = encoder.apply(params["encoder"], batch["obs"]).detach()
        a = det_actor(params["actor"], feats)
        return -q_critic(params["q"], feats, a).mean()

    def update(state: TrainState, batch, gen=None, *, noise=None):
        params, target, opt_state = state
        cgrads, closs = grad_and_value(critic_loss)(params, target, batch)
        agrads, aloss = grad_and_value(actor_loss)(params, batch)
        params, opt_state = opt.update(params, opt_state,
                                       add_trees(cgrads, agrads))
        metrics = {"critic_loss": closs, "actor_loss": aloss}
        return TrainState(params, target, opt_state), metrics

    def target_update(state: TrainState) -> TrainState:
        return state._replace(target=ema_update(state.target, state.params,
                                                cfg.tau))

    def act(params, obs, gen=None, *, noise=None):
        feats = encoder.apply(params["encoder"], obs)
        a = det_actor(params["actor"], feats)
        if noise is None:
            noise = act_noise(gen, a.shape[0], action_dim)
        return torch.clamp(a + cfg.action_noise * noise, -1, 1), {}

    def policy_head(params):
        actor = params["actor"]
        return lambda feats: det_actor(actor, feats)

    return Agent(name="ddpg", cfg=cfg, encoder=encoder,
                 action_dim=action_dim, on_policy=False, init=init, act=act,
                 update=update, draw_noise=no_noise,
                 target_update=target_update, policy_head=policy_head)
__all__ = ["DDPGConfig", "add_trees", "init_ddpg", "make_ddpg_agent"]
