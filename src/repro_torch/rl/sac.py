"""SAC (Haarnoja et al., 2018) — the paper's Hopper algorithm (port of
``repro.rl.sac``).

Twin Q critics, squashed-Gaussian actor, automatic entropy tuning (target
entropy = -|A|), Polyak target updates.  Pixel convention (DrQ-style,
matching SB3's shared feature extractor): the encoder is trained by the
critic loss; actor gradients stop at the features.

An update's randomness is two standard-normal draws of shape
``(batch, action_dim)``: the next action's (the reference's ``k1``) and
the actor loss's (``k2``); ``update`` takes them as ``noise=(eps1,
eps2)`` or draws them from ``gen``.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, FrozenSet

import torch
from torch.func import grad_and_value

from repro_torch.nn.module import tree_map
from repro_torch.rl.agent import Agent, TrainState, act_noise
from repro_torch.rl.ddpg import add_trees
from repro_torch.rl.networks import (FEATURE_DIM, Encoder, q_critic,
                                     q_critic_init, squashed_actor_init,
                                     squashed_actor_mode,
                                     squashed_actor_sample)
from repro_torch.train.optimizer import adam, ema_update


@dataclasses.dataclass(frozen=True)
class SACConfig:
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    batch_size: int = 64
    buffer_size: int = 20_000
    learning_starts: int = 500
    train_freq: int = 1           # gradient steps per env step (per env)
    init_alpha: float = 0.1
    n_envs: int = 4               # parallel envs in the vectorised engine

    # Fields that only feed arithmetic (never shapes, loop lengths or
    # buffer sizes): the ones a population may vary across its members.
    VMAPPABLE: ClassVar[FrozenSet[str]] = frozenset(
        {"gamma", "tau", "lr", "init_alpha"})


def init_sac(gen, encoder: Encoder, action_dim: int, device,
             init_alpha: float = SACConfig.init_alpha):
    params = {
        "encoder": encoder.init(gen),
        "actor": squashed_actor_init(gen, FEATURE_DIM, action_dim,
                                     device=device),
        "q1": q_critic_init(gen, FEATURE_DIM, action_dim, device=device),
        "q2": q_critic_init(gen, FEATURE_DIM, action_dim, device=device),
        "log_alpha": torch.log(torch.tensor(init_alpha)).to(device),
    }
    target = {"encoder": params["encoder"], "q1": params["q1"],
              "q2": params["q2"]}
    return params, tree_map(torch.clone, target)


def make_sac_agent(encoder: Encoder, action_dim: int, cfg: SACConfig,
                   device) -> Agent:
    """SAC behind the uniform :class:`~repro_torch.rl.agent.Agent`
    protocol."""
    opt = adam(cfg.lr, clip_norm=10.0)
    target_entropy = -float(action_dim)

    def init(gen) -> TrainState:
        # cfg.init_alpha, not the class default: a configured temperature
        # must reach the initial log_alpha
        params, target = init_sac(gen, encoder, action_dim, device,
                                  init_alpha=cfg.init_alpha)
        return TrainState(params, target, opt.init(params))

    def critic_loss(params, target, batch, eps):
        feats = encoder.apply(params["encoder"], batch["obs"])
        tfeats = encoder.apply(target["encoder"], batch["next_obs"])
        next_a, next_logp, _ = squashed_actor_sample(
            params["actor"], tfeats.detach(), eps)
        tq1 = q_critic(target["q1"], tfeats, next_a)
        tq2 = q_critic(target["q2"], tfeats, next_a)
        alpha = torch.exp(params["log_alpha"])
        tq = torch.minimum(tq1, tq2) - alpha * next_logp
        y = batch["rewards"] + cfg.gamma * (1 - batch["dones"]) * tq
        y = y.detach()
        q1 = q_critic(params["q1"], feats, batch["actions"])
        q2 = q_critic(params["q2"], feats, batch["actions"])
        return torch.square(q1 - y).mean() + torch.square(q2 - y).mean()

    def actor_alpha_loss(params, batch, eps):
        feats = encoder.apply(params["encoder"], batch["obs"]).detach()
        a, logp, _ = squashed_actor_sample(params["actor"], feats, eps)
        alpha = torch.exp(params["log_alpha"])
        q = torch.minimum(q_critic(params["q1"], feats, a),
                          q_critic(params["q2"], feats, a))
        actor_loss = (alpha.detach() * logp - q).mean()
        alpha_loss = -(params["log_alpha"]
                       * (logp + target_entropy).detach()).mean()
        return actor_loss + alpha_loss, (actor_loss, alpha_loss)

    def draw_noise(gen, batch):
        shape = (batch["actions"].shape[0], action_dim)
        return tuple(torch.randn(shape, generator=gen, device=gen.device)
                     for _ in range(2))

    def update(state: TrainState, batch, gen=None, *, noise=None):
        params, target, opt_state = state
        eps1, eps2 = draw_noise(gen, batch) if noise is None else noise
        cgrads, closs = grad_and_value(critic_loss)(params, target, batch,
                                                    eps1)
        # critic grads touch encoder + q1 + q2 (+ log_alpha has zero grad)
        agrads, (_, (aloss, _)) = grad_and_value(
            actor_alpha_loss, has_aux=True)(params, batch, eps2)
        params, opt_state = opt.update(params, opt_state,
                                       add_trees(cgrads, agrads))
        metrics = {"critic_loss": closs, "actor_loss": aloss,
                   "alpha": torch.exp(params["log_alpha"])}
        return TrainState(params, target, opt_state), metrics

    def target_update(state: TrainState) -> TrainState:
        new_target = ema_update(
            state.target,
            {"encoder": state.params["encoder"], "q1": state.params["q1"],
             "q2": state.params["q2"]},
            cfg.tau)
        return state._replace(target=new_target)

    def act(params, obs, gen=None, *, noise=None):
        feats = encoder.apply(params["encoder"], obs)
        if noise is None:
            noise = act_noise(gen, feats.shape[0], action_dim)
        a, _, _ = squashed_actor_sample(params["actor"], feats, noise)
        return a, {}

    def policy_head(params):
        actor = params["actor"]
        return lambda feats: squashed_actor_mode(actor, feats)

    return Agent(name="sac", cfg=cfg, encoder=encoder,
                 action_dim=action_dim, on_policy=False, init=init, act=act,
                 update=update, draw_noise=draw_noise,
                 target_update=target_update, policy_head=policy_head)


__all__ = ["SACConfig", "init_sac", "make_sac_agent"]
