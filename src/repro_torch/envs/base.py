"""Batched functional environment interface (port of ``repro.envs.base``).

The reference writes one environment's pure functions and ``jax.vmap``s
them; here every function is written over a leading ``(N,)`` env axis, so
a state is a NamedTuple of ``(N, ...)`` tensors on one device and a step
is a handful of whole-batch tensor operations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

State = Any


@dataclasses.dataclass(frozen=True)
class Env:
    """Bundle of batched pure functions defining one environment.

    reset_from(u) -> state             [u: (N, n_uniform) uniform in [0, 1)]
    step(state, action) -> (state, reward, done)   [action: (N, action_dim)]
    render(state, window=None) -> (N, res, res, 3) float32 in [0, 1]; with
        ``window=(oy, ox, size)`` only that (size, size) crop of each frame,
        equal to cropping the full frame
    """

    name: str
    reset_from: Callable
    n_uniform: int
    step: Callable
    render: Callable
    action_dim: int
    max_steps: int
    resolution: int = 100

    def draw(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """The ``(n, n_uniform)`` uniform draws of ``gen`` (on its device)
        that :meth:`reset` maps to states."""
        return torch.rand((n, self.n_uniform), generator=gen,
                          device=gen.device)

    def reset(self, gen: torch.Generator, n: int) -> State:
        """``n`` fresh states from uniform draws of ``gen``."""
        return self.reset_from(self.draw(gen, n))


def uniform(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """Map uniform [0, 1) draws onto [minval, maxval) as
    ``jax.random.uniform`` does: ``max(minval, u * (maxval - minval) +
    minval)``."""
    return torch.clamp(u * (maxval - minval) + minval, min=minval)


__all__ = ["Env", "State", "uniform"]
