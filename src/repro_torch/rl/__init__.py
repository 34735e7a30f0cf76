"""RL substrate of the port (``repro.rl`` counterparts): PPO / SAC / DDPG
with swappable observation encoders, trained on the device.

One protocol, one driver: every algorithm is a frozen
:class:`~repro_torch.rl.agent.Agent` bundle, run by an
:class:`~repro_torch.rl.rollout.Engine`, driven by the generic
:func:`~repro_torch.rl.train.train` loop::

    from repro_torch.rl import train
    res = train("hopper", "miniconv4", total_steps=20_000)   # SAC, cuda
    res.params                       # trained parameters, ready to serve
    res.summary()                    # best/mean/final + steps/sec

Module map: ``agent`` (the protocol, ``TrainState``, ``make_agent``),
``ppo`` / ``sac`` / ``ddpg`` (the algorithms as ``Agent`` factories),
``rollout`` (the engines), ``buffers`` (the device replay ring and the
numpy reference), ``networks`` (encoders and heads), ``train`` (the
driver and :class:`TrainResult`), ``population`` (P = seeds ×
hyperparameter variants × tasks a program, in exact lanes — each member
bitwise a ``train()`` run — or batched lanes under ``torch.func.vmap``,
plus the paper's deterministic final-100-episode eval protocol,
``evaluate`` / ``final_100_mean``, and ``best_member()`` feeding
``Deployment.export_best``).
"""

from repro_torch.rl.agent import Agent, TrainState, make_agent
from repro_torch.rl.train import TASK_ALGO, TrainResult, train, \
    train_population

__all__ = ["train", "train_population", "TrainResult", "TASK_ALGO",
           "Agent", "TrainState", "make_agent"]
