"""Pendulum-v1 (Classic Control), batched (port of ``repro.envs.pendulum``).

theta'' = 3g/(2l) sin(theta) + 3/(m l^2) u,  dt = 0.05, |u| <= 2,
reward = -(angle_norm^2 + 0.1 theta_dot^2 + 0.001 u^2), 200-step episodes.
Rendered with the default static camera: rod from the pivot, bob at the tip.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.envs.base import Env, uniform
from repro_torch.envs.rendering import (Camera, blank, draw_capsule,
                                        draw_circle)

_G, _M, _L, _DT = 10.0, 1.0, 1.0, 0.05
MAX_TORQUE = 2.0
MAX_SPEED = 8.0


class PendulumState(NamedTuple):
    theta: torch.Tensor           # (N,)
    theta_dot: torch.Tensor       # (N,)
    t: torch.Tensor               # (N,) int32


def _angle_normalize(x):
    # floor-mod, as Python's and jnp's ``%``
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def reset_from(u: torch.Tensor) -> PendulumState:
    return PendulumState(uniform(u[:, 0], -math.pi, math.pi),
                         uniform(u[:, 1], -1.0, 1.0),
                         torch.zeros(u.shape[0], dtype=torch.int32,
                                     device=u.device))


def step(state: PendulumState, action):
    # policy actions live in [-1, 1]; scale to the torque limit
    u = torch.clamp(action[:, 0] * MAX_TORQUE, -MAX_TORQUE, MAX_TORQUE)
    th, thdot = state.theta, state.theta_dot
    an = _angle_normalize(th)
    cost = an * an + 0.1 * (thdot * thdot) + 0.001 * (u * u)
    newthdot = thdot + (3 * _G / (2 * _L) * torch.sin(th)
                        + 3.0 / (_M * _L ** 2) * u) * _DT
    newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
    newth = th + newthdot * _DT
    new = PendulumState(newth, newthdot, state.t + 1)
    done = new.t >= 200
    return new, -cost, done


_CAM = Camera(center_x=0.0, center_y=0.0, half_extent=1.5)


def render(state: PendulumState, window=None):
    th = state.theta
    n, dev = th.shape[0], th.device
    grid = _CAM.grid(n, dev, window)
    # Gym convention: theta=0 is upright
    tip_x = _L * torch.sin(th)
    tip_y = _L * torch.cos(th)
    img = blank(n, *grid[0].shape[1:], dev)
    img = draw_capsule(img, grid, 0.0, 0.0, tip_x, tip_y, 0.09,
                       (0.8, 0.3, 0.3))
    img = draw_circle(img, grid, 0.0, 0.0, 0.06, (0.1, 0.1, 0.1))
    img = draw_circle(img, grid, tip_x, tip_y, 0.12, (0.2, 0.2, 0.7))
    return img


ENV = Env(name="pendulum", reset_from=reset_from, n_uniform=2, step=step,
          render=render, action_dim=1, max_steps=200)
