"""PPO (Schulman et al., 2017) — the paper's Walker2d algorithm (port of
``repro.rl.ppo``).

Clipped surrogate updates with GAE over vectorised rollouts (the rollout
loop lives in ``repro_torch.rl.rollout``; this module is the algorithm
only).  Hyperparameters follow SB3 defaults unless overridden.

``act`` returns the sampled action plus the ``logp``/``value`` extras the
trajectory stores; ``update`` consumes the whole rollout
(``{"traj": ..., "last_obs": ...}``): GAE, then ``n_epochs`` passes of
``n_minibatches`` Adam steps.  Its randomness is one permutation of the
``T * N`` samples an epoch, taken as ``noise`` (an ``(n_epochs, T * N)``
index tensor) or drawn from ``gen``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, FrozenSet

import torch
from torch.func import grad_and_value

from repro_torch.rl.agent import Agent, TrainState, act_noise
from repro_torch.rl.networks import (FEATURE_DIM, Encoder, gaussian_actor,
                                     gaussian_actor_init, mlp_apply,
                                     v_critic, v_critic_init)
from repro_torch.train.optimizer import adam

# the reference's ``jnp.log(2 * jnp.pi)`` and ``jnp.log(2 * jnp.pi *
# jnp.e)``: float32 logs of the float32-rounded arguments
_LOG_2PI = float(torch.log(torch.tensor(2 * math.pi)))
_LOG_2PIE = float(torch.log(torch.tensor(2 * math.pi * math.e)))


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 8
    n_steps: int = 128           # rollout horizon per env
    n_epochs: int = 4
    n_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    quantize_wire: bool = False  # straight-through uint8 wire in training

    # Fields that only feed arithmetic (never shapes, loop lengths or
    # buffer sizes): the ones a population may vary across its members.
    VMAPPABLE: ClassVar[FrozenSet[str]] = frozenset(
        {"gamma", "gae_lambda", "clip_eps", "vf_coef", "ent_coef", "lr",
         "max_grad_norm"})


def init_ppo(gen, encoder: Encoder, action_dim: int, device):
    return {
        "encoder": encoder.init(gen),
        "actor": gaussian_actor_init(gen, FEATURE_DIM, action_dim,
                                     device=device),
        "critic": v_critic_init(gen, FEATURE_DIM, device=device),
    }


def _policy(params, encoder: Encoder, obs):
    feats = encoder.apply(params["encoder"], obs)
    mean, log_std = gaussian_actor(params["actor"], feats)
    value = v_critic(params["critic"], feats)
    return mean, log_std, value


def _logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    d = action - mean
    return (-0.5 * (d * d / var + 2 * log_std + _LOG_2PI)).sum(-1)


def gae(traj, last_value, gamma: float, gae_lambda: float):
    """Advantages and returns of a ``(T, N)`` rollout, from the last step
    back (the reference's reverse ``lax.scan``)."""
    T = traj["reward"].shape[0]
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = []
    for t in range(T - 1, -1, -1):
        nonterm = 1.0 - traj["done"][t].to(torch.float32)
        delta = traj["reward"][t] + gamma * v_next * nonterm \
            - traj["value"][t]
        adv_next = delta + gamma * gae_lambda * nonterm * adv_next
        v_next = traj["value"][t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + traj["value"]


def make_ppo_agent(encoder: Encoder, action_dim: int, cfg: PPOConfig,
                   device) -> Agent:
    """PPO behind the uniform :class:`~repro_torch.rl.agent.Agent`
    protocol."""
    opt = adam(cfg.lr, clip_norm=cfg.max_grad_norm)

    def init(gen) -> TrainState:
        params = init_ppo(gen, encoder, action_dim, device)
        return TrainState(params, {}, opt.init(params))

    def act(params, obs, gen=None, *, noise=None):
        mean, log_std, value = _policy(params, encoder, obs)
        if noise is None:
            noise = act_noise(gen, mean.shape[0], action_dim)
        action = mean + torch.exp(log_std) * noise
        return action, {"logp": _logp(mean, log_std, action),
                        "value": value}

    def loss_fn(params, batch):
        mean, log_std, value = _policy(params, encoder, batch["obs"])
        logp = _logp(mean, log_std, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        # numpy's (and jnp's) population std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_loss = 0.5 * torch.square(value - batch["ret"]).mean()
        entropy = (log_std + 0.5 * _LOG_2PIE).sum(-1).mean()
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        return loss, {"pg_loss": pg_loss, "v_loss": v_loss,
                      "entropy": entropy,
                      "approx_kl": ((ratio - 1) - torch.log(ratio)).mean()}

    def draw_noise(gen, data):
        n = data["traj"]["reward"].numel()
        return torch.stack([torch.randperm(n, generator=gen,
                                           device=gen.device)
                            for _ in range(cfg.n_epochs)])

    def update(state: TrainState, data, gen=None, *, noise=None):
        params, _, opt_state = state
        traj, last_obs = data["traj"], data["last_obs"]
        perms = draw_noise(gen, data) if noise is None else noise
        _, _, last_value = _policy(params, encoder, last_obs)
        advs, returns = gae(traj, last_value, cfg.gamma, cfg.gae_lambda)
        T, N = traj["reward"].shape
        flat = {
            "obs": traj["obs"].reshape(T * N, *traj["obs"].shape[2:]),
            "action": traj["action"].reshape(T * N, -1),
            "logp": traj["logp"].reshape(T * N),
            "adv": advs.reshape(T * N),
            "ret": returns.reshape(T * N),
        }
        mb = T * N // cfg.n_minibatches
        auxs = []
        for e in range(cfg.n_epochs):
            idxs = perms[e].reshape(cfg.n_minibatches, mb)
            for i in range(cfg.n_minibatches):
                batch = {k: v[idxs[i]] for k, v in flat.items()}
                grads, (_, aux) = grad_and_value(loss_fn, has_aux=True)(
                    params, batch)
                params, opt_state = opt.update(params, opt_state, grads)
                auxs.append(aux)
        metrics = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        metrics["mean_reward"] = traj["reward"].mean()
        return TrainState(params, {}, opt_state), metrics

    def act_greedy_head(params):
        actor = params["actor"]
        return lambda feats: torch.clamp(mlp_apply(actor["mlp"], feats),
                                         -1, 1)

    return Agent(name="ppo", cfg=cfg, encoder=encoder,
                 action_dim=action_dim, on_policy=True, init=init, act=act,
                 update=update, draw_noise=draw_noise,
                 target_update=lambda state: state,
                 policy_head=act_greedy_head)


__all__ = ["PPOConfig", "gae", "init_ppo", "make_ppo_agent"]
