"""Hopper2D — simplified planar one-legged hopper (SLIP-style), batched
(port of ``repro.envs.hopper``).

A spring-loaded-inverted-pendulum body with actuated leg thrust, hip
torque, and leg-length rate: continuous actions (3), pixel observations
via a tracking camera, reward = forward velocity + alive bonus - control
cost, termination on falling.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.envs.base import Env, uniform
from repro_torch.envs.rendering import (Camera, blank, draw_capsule,
                                        draw_checker_ground, draw_circle)

_DT = 0.02
_G = 9.8
_M = 1.0          # body mass
_L0 = 0.55        # rest leg length
_KSPRING = 140.0  # leg spring
_DAMP = 4.0
MAX_STEPS = 400


class HopperState(NamedTuple):
    x: torch.Tensor           # body horizontal position, (N,)
    z: torch.Tensor           # body height
    vx: torch.Tensor
    vz: torch.Tensor
    leg_angle: torch.Tensor   # from vertical, + = forward
    leg_len: torch.Tensor
    t: torch.Tensor           # (N,) int32


def reset_from(u: torch.Tensor) -> HopperState:
    n, dev = u.shape[0], u.device
    zeros = torch.zeros(n, device=dev)
    return HopperState(
        x=zeros,
        z=_L0 + 0.25 + uniform(u[:, 0], 0.0, 0.05),
        vx=zeros,
        vz=zeros,
        leg_angle=uniform(u[:, 1], -0.05, 0.05),
        leg_len=torch.full((n,), _L0, device=dev),
        t=torch.zeros(n, dtype=torch.int32, device=dev),
    )


def _foot(state: HopperState):
    fx = state.x + state.leg_len * torch.sin(state.leg_angle)
    fz = state.z - state.leg_len * torch.cos(state.leg_angle)
    return fx, fz


def step(state: HopperState, action):
    thrust = torch.clamp(action[:, 0], -1, 1) * 90.0   # spring pre-load
    hip = torch.clamp(action[:, 1], -1, 1) * 3.0       # leg swing rate
    rate = torch.clamp(action[:, 2], -1, 1) * 0.6      # leg length rate

    fx, fz = _foot(state)
    in_stance = fz <= 0.0

    # stance: spring force along the leg (plus thrust), acting on the body
    compression = torch.clamp(_L0 - state.leg_len, min=0.0)
    spring_f = torch.where(in_stance,
                           _KSPRING * compression
                           + torch.clamp(thrust, min=0.0)
                           - _DAMP * (-state.vz), 0.0)
    ax = spring_f * torch.sin(state.leg_angle) / _M * (-1.0)
    az = spring_f * torch.cos(state.leg_angle) / _M - _G

    # stance foot friction damps horizontal motion a little
    ax = ax - torch.where(in_stance, 0.8 * state.vx, 0.0)

    vx = state.vx + ax * _DT
    vz = state.vz + az * _DT
    x = state.x + vx * _DT
    z = state.z + vz * _DT

    # leg control: swing in flight, compress/extend always
    leg_angle = state.leg_angle + hip * _DT * torch.where(in_stance, 0.25,
                                                          1.0)
    leg_angle = torch.clamp(leg_angle, -0.7, 0.7)
    leg_len = torch.clamp(state.leg_len + rate * _DT
                          - torch.where(in_stance, 0.5 * compression * _DT,
                                        0.0),
                          0.6 * _L0, 1.15 * _L0)

    # stance constraint: keep body above ground through the leg
    z = torch.clamp(z, min=0.35 * _L0)

    new = HopperState(x, z, vx, vz, leg_angle, leg_len, state.t + 1)

    a0, a1, a2 = action[:, 0], action[:, 1], action[:, 2]
    ctrl_cost = 1e-3 * (a0 * a0 + a1 * a1 + a2 * a2)
    healthy = (z > 0.45) & (torch.abs(leg_angle) < 0.69)
    reward = vx + 1.0 * healthy.to(torch.float32) - ctrl_cost
    done = (~healthy) | (new.t >= MAX_STEPS)
    return new, reward, done


def render(state: HopperState, window=None):
    n, dev = state.x.shape[0], state.x.device
    grid = Camera(center_x=state.x, center_y=0.6,
                  half_extent=1.1).grid(n, dev, window)
    img = blank(n, *grid[0].shape[1:], dev)
    img = draw_checker_ground(img, grid, 0.0)
    fx, fz = _foot(state)
    img = draw_capsule(img, grid, state.x, state.z, fx,
                       torch.clamp(fz, min=0.0), 0.05, (0.85, 0.45, 0.2))
    img = draw_circle(img, grid, state.x, state.z, 0.16, (0.2, 0.3, 0.8))
    img = draw_circle(img, grid, fx, torch.clamp(fz, min=0.02), 0.06,
                      (0.15, 0.15, 0.15))
    return img


ENV = Env(name="hopper", reset_from=reset_from, n_uniform=2, step=step,
          render=render, action_dim=3, max_steps=MAX_STEPS)
