"""Split-policy RL trainer for the paper's pairings (port of
``repro.rl.train``):

  Walker2d  + PPO   (Table 2)
  Hopper    + SAC   (Table 3)
  Pendulum  + DDPG  (Table 4)

Each condition swaps ONLY the observation encoder (Full-CNN vs MiniConv
K=4 / K=16), as in the paper; the heads, algorithm and hyperparameters are
fixed within a task.  One generic driver: the algorithm is a frozen
:class:`~repro_torch.rl.agent.Agent` bundle and the loop an
:class:`~repro_torch.rl.rollout.Engine`; only each chunk's ``(T, N)``
rewards and dones cross to the host, for episode tracking.

Reports Best / Mean / Final (mean over the last 100 episodes) per the
paper's summary statistics; episodes truncated by the end of training are
counted explicitly (``truncated_returns``).  Training runs on the GPU
unless ``device="cpu"`` is given; it never falls back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.envs import make_pixel_env
from repro_torch.rl.agent import make_agent
from repro_torch.rl.rollout import make_engine, to_host

TASK_ALGO = {"walker": "ppo", "hopper": "sac", "pendulum": "ddpg"}


def _pipeline_encoder(encoder_name: str, c_in: int, *,
                      deploy_config=None, device: DeviceLike = None):
    """Every trainer builds its encoder pipeline through
    ``Deployment.build``.

    Training runs the differentiable ``xla`` backend (eager PyTorch); the
    SAME DeploymentConfig, with a serving backend swapped in, later serves
    the trained parameters, so train and deploy never disagree on the
    spec, plan or head.  ``full_cnn`` has no split pipeline.
    """
    # lazy: repro_torch.deploy composes rl.networks primitives
    from repro_torch.deploy import Deployment, DeploymentConfig
    from repro_torch.rl.networks import make_encoder
    if deploy_config is not None:
        return Deployment.build(deploy_config, device=device).encoder
    if encoder_name == "full_cnn":
        return make_encoder(encoder_name, c_in=c_in, device=device)
    cfg = DeploymentConfig.from_encoder_name(encoder_name, c_in=c_in,
                                             backend="xla")
    return Deployment.build(cfg, device=device).encoder


@dataclasses.dataclass
class TrainResult:
    task: str
    algo: str
    encoder: str
    episode_returns: list[float]
    wall_time_s: float
    truncated_returns: list[float] = dataclasses.field(default_factory=list)
    env_steps: int = 0
    params: Any = None            # trained parameters (TrainState.params)
    # warm-up/steady split: the FIRST call of each distinct phase shape
    # pays the allocator's first allocations and cuDNN's algorithm search;
    # repeated shapes run warm.  The driver records both.
    compile_s: float = 0.0        # wall spent in first-call phases
    steady_env_steps: int = 0     # env steps from repeated phases
    steady_wall_s: float = 0.0    # wall spent in repeated phases
    # one (phase, wall seconds, metrics) a phase of the plan, the metrics
    # as the engine returned them (device tensors), and the engine's
    # final carry (state, envs, ring, generator) to go on from
    phases: list = dataclasses.field(default_factory=list)
    carry: Any = None

    @property
    def all_returns(self) -> list[float]:
        """Completed episodes followed by the end-of-training truncated
        partials."""
        return self.episode_returns + self.truncated_returns

    @property
    def _stat_returns(self) -> list[float]:
        """Best/Mean/Final are per-EPISODE statistics: completed episodes
        whenever any exist; only a run too short to complete one (smoke
        scale) falls back on the truncated partials."""
        return self.episode_returns or self.truncated_returns

    @property
    def best(self) -> float:
        r = self._stat_returns
        return max(r) if r else float("nan")

    @property
    def mean(self) -> float:
        r = self._stat_returns
        return float(np.mean(r)) if r else float("nan")

    @property
    def final(self) -> float:
        """Mean episodic return over the final 100 episodes (paper metric)."""
        r = self._stat_returns
        if not r:
            return float("nan")
        return float(np.mean(r[-100:]))

    @property
    def steps_per_sec(self) -> float:
        """End-to-end throughput (warm-up included)."""
        return self.env_steps / self.wall_time_s if self.wall_time_s > 0 \
            else float("nan")

    @property
    def steady_steps_per_sec(self) -> float:
        """Throughput of the repeated (warm) phases only; NaN when no
        phase shape repeated."""
        if self.steady_wall_s > 0 and self.steady_env_steps > 0:
            return self.steady_env_steps / self.steady_wall_s
        return float("nan")

    def summary(self) -> dict:
        return {"task": self.task, "algo": self.algo, "encoder": self.encoder,
                "best": self.best, "final": self.final, "mean": self.mean,
                "episodes": len(self.all_returns),
                "episodes_completed": len(self.episode_returns),
                "episodes_truncated": len(self.truncated_returns),
                "env_steps": self.env_steps,
                "steps_per_sec": self.steps_per_sec,
                "compile_s": self.compile_s,
                # null (not NaN) in JSON artifacts when no phase repeated
                "steady_steps_per_sec": (
                    self.steady_steps_per_sec
                    if np.isfinite(self.steady_steps_per_sec) else None)}


def _track_episodes(returns_buf, ep_ret, ep_len, rewards, dones):
    """Accumulate per-env episodic returns from (T, N) reward/done arrays.

    ``ep_len`` counts steps since each env's last completed episode so the
    driver can flush started partial episodes at the end of training
    (:func:`_flush_truncated`) instead of dropping them.
    """
    rewards = np.asarray(rewards)
    dones = np.asarray(dones)
    for t in range(rewards.shape[0]):
        ep_ret += rewards[t]
        ep_len += 1
        for i in np.nonzero(dones[t])[0]:
            returns_buf.append(float(ep_ret[i]))
            ep_ret[i] = 0.0
            ep_len[i] = 0
    return ep_ret, ep_len


def _flush_truncated(ep_ret, ep_len) -> list[float]:
    """Partial returns of episodes cut off by the end of training — one per
    env that has taken at least one step since its last done."""
    return [float(ep_ret[i]) for i in np.nonzero(ep_len > 0)[0]]


def train(task: str, encoder_name: str, *, total_steps: int = 20_000,
          seed: int = 0, verbose: bool = False, log_every: int = 10,
          cfg: Any = None, n_envs: Optional[int] = None,
          deploy_config=None, device: DeviceLike = None) -> TrainResult:
    """Train the paper's (task, algorithm) pairing with a given encoder on
    ``device`` (``"cuda"`` by default; ``"cpu"`` only when asked).

    ``deploy_config`` trains against an explicit
    :class:`repro_torch.deploy.DeploymentConfig` (a manifest) instead of
    the named encoder's default.  ``cfg`` overrides the algorithm config;
    ``n_envs`` just the parallel-env count.  The returned
    :class:`TrainResult` carries the trained parameters, ready to serve
    through ``Deployment.serving_pair``, each phase's time and metrics,
    and the final carry.
    """
    dev = resolve_device(device)
    algo = TASK_ALGO[task]
    env = make_pixel_env(task, train=True)
    encoder = _pipeline_encoder(encoder_name, env.obs_shape[-1],
                                deploy_config=deploy_config, device=dev)
    agent = make_agent(algo, encoder, env.action_dim, cfg=cfg, n_envs=n_envs,
                       device=dev)
    engine = make_engine(env, agent, total_steps, device=dev)
    carry = engine.init(seed)

    returns: list[float] = []
    ep_ret = np.zeros(engine.n_envs)
    ep_len = np.zeros(engine.n_envs, np.int64)
    env_steps = 0
    compile_s = 0.0
    steady_steps = 0
    steady_s = 0.0
    seen_shapes: set = set()
    phases = []
    t0 = time.time()
    for it, phase in enumerate(engine.plan()):
        t_call = time.time()
        carry, rewards, dones, metrics = engine.run(carry, phase)
        # the phase's one host copy: its rewards and dones
        rewards, dones = to_host(rewards, dones)
        dt = time.time() - t_call
        ep_ret, ep_len = _track_episodes(returns, ep_ret, ep_len,
                                         rewards, dones)
        chunk_steps = int(rewards.size)
        env_steps += chunk_steps
        # the first call of a phase shape warms the allocator and cuDNN;
        # repeats run warm — split the wall accordingly
        if phase in seen_shapes:
            steady_steps += chunk_steps
            steady_s += dt
        else:
            seen_shapes.add(phase)
            compile_s += dt
        phases.append((phase, dt, metrics))
        if verbose and it % log_every == 0:
            shown = " ".join(f"{k}={float(v):.3f}"
                             for k, v in sorted(metrics.items()))
            print(f"  [{algo} {encoder_name}] {phase[0]} {it} {shown} "
                  f"episodes={len(returns)}")
    truncated = _flush_truncated(ep_ret, ep_len)
    return TrainResult(task, algo, encoder_name, returns,
                       time.time() - t0, truncated_returns=truncated,
                       env_steps=env_steps, params=carry.state.params,
                       compile_s=compile_s, steady_env_steps=steady_steps,
                       steady_wall_s=steady_s, phases=phases, carry=carry)


def train_population(spec, **kwargs):
    """Population driver — P members a program, in exact or batched
    lanes.  Thin re-export; see
    :func:`repro_torch.rl.population.train_population` (imported lazily:
    population composes this module's helpers)."""
    from repro_torch.rl.population import \
        train_population as _train_population
    return _train_population(spec, **kwargs)


__all__ = ["TASK_ALGO", "TrainResult", "train", "train_population"]
