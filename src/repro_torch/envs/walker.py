"""Walker2D — simplified planar biped, batched (port of
``repro.envs.walker``).

A torso with two telescoping torque-swung legs and spring-damper ground
contact: 6 continuous actions, pixel observations via a tracking camera,
reward = forward velocity + alive bonus - control cost, termination when
the torso falls or pitches over.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.envs.base import Env, uniform
from repro_torch.envs.rendering import (Camera, blank, draw_capsule,
                                        draw_checker_ground, draw_circle)

_DT = 0.02
_G = 9.8
_M = 1.2
_I = 0.12          # torso moment of inertia
_L0 = 0.5
_KC = 220.0        # contact spring
_DC = 9.0          # contact damping
MAX_STEPS = 400


class WalkerState(NamedTuple):
    x: torch.Tensor           # (N,)
    z: torch.Tensor
    pitch: torch.Tensor
    vx: torch.Tensor
    vz: torch.Tensor
    vpitch: torch.Tensor
    leg_angle: torch.Tensor   # (N, 2) from vertical
    leg_len: torch.Tensor     # (N, 2)
    t: torch.Tensor           # (N,) int32


def reset_from(u: torch.Tensor) -> WalkerState:
    n, dev = u.shape[0], u.device
    zeros = torch.zeros(n, device=dev)
    base = torch.zeros((n, 2), device=dev)
    base[:, 0], base[:, 1] = 0.12, -0.12
    return WalkerState(
        x=zeros, z=torch.full((n,), _L0 + 0.12, device=dev),
        pitch=uniform(u[:, 0], -0.03, 0.03),
        vx=zeros, vz=zeros, vpitch=zeros,
        leg_angle=base + uniform(u[:, 1:3], -0.03, 0.03),
        leg_len=torch.full((n, 2), _L0, device=dev),
        t=torch.zeros(n, dtype=torch.int32, device=dev),
    )


def _feet(state: WalkerState):
    fx = state.x[:, None] + state.leg_len * torch.sin(state.leg_angle)
    fz = state.z[:, None] - state.leg_len * torch.cos(state.leg_angle)
    return fx, fz


def _sum2(v):
    return v[:, 0] + v[:, 1]


def step(state: WalkerState, action):
    action = torch.clamp(action, -1, 1)
    hip = action[:, :2] * 4.0       # swing rate per leg
    knee = action[:, 2:4] * 0.8     # length rate per leg
    push = action[:, 4:6] * 60.0    # extension force per leg (push-off)

    fx, fz = _feet(state)
    pen = torch.clamp(-fz, min=0.0)                   # ground penetration
    in_stance = pen > 0.0

    # contact force along each leg (spring-damper + actuated push)
    f_leg = torch.where(in_stance,
                        _KC * pen - _DC * state.vz[:, None]
                        + torch.clamp(push, min=0.0), 0.0)
    f_leg = torch.clamp(f_leg, min=0.0)

    ax = _sum2(-f_leg * torch.sin(state.leg_angle)) / _M
    az = _sum2(f_leg * torch.cos(state.leg_angle)) / _M - _G
    # stance friction + hip reaction torque pitches the torso
    ax = ax - _sum2(torch.where(in_stance, 0.6, 0.0)) * state.vx / _M
    torque = _sum2(torch.where(in_stance, -0.15 * hip, 0.02 * hip))
    apitch = (torque - 2.2 * state.pitch - 0.5 * state.vpitch) / _I

    vx = state.vx + ax * _DT
    vz = state.vz + az * _DT
    vpitch = state.vpitch + apitch * _DT
    x = state.x + vx * _DT
    z = torch.clamp(state.z + vz * _DT, min=0.3 * _L0)
    pitch = state.pitch + vpitch * _DT

    leg_angle = torch.clamp(state.leg_angle
                            + hip * _DT * torch.where(in_stance, 0.3, 1.0),
                            -0.8, 0.8)
    leg_len = torch.clamp(state.leg_len + knee * _DT, 0.55 * _L0,
                          1.2 * _L0)

    new = WalkerState(x, z, pitch, vx, vz, vpitch, leg_angle, leg_len,
                      state.t + 1)

    ctrl_cost = 1e-3 * torch.sum(action * action, dim=-1)
    healthy = (z > 0.4) & (torch.abs(pitch) < 1.0)
    reward = vx + 1.0 * healthy.to(torch.float32) - ctrl_cost
    done = (~healthy) | (new.t >= MAX_STEPS)
    return new, reward, done


def render(state: WalkerState, window=None):
    n, dev = state.x.shape[0], state.x.device
    grid = Camera(center_x=state.x, center_y=0.6,
                  half_extent=1.1).grid(n, dev, window)
    img = blank(n, *grid[0].shape[1:], dev)
    img = draw_checker_ground(img, grid, 0.0)
    fx, fz = _feet(state)
    colors = [(0.85, 0.45, 0.2), (0.7, 0.25, 0.45)]
    for i in range(2):
        img = draw_capsule(img, grid, state.x, state.z, fx[:, i],
                           torch.clamp(fz[:, i], min=0.0), 0.05, colors[i])
        img = draw_circle(img, grid, fx[:, i],
                          torch.clamp(fz[:, i], min=0.02), 0.055,
                          (0.15, 0.15, 0.15))
    # torso drawn as a tilted capsule
    tx = state.x + 0.35 * torch.sin(state.pitch)
    tz = state.z + 0.35 * torch.cos(state.pitch)
    img = draw_capsule(img, grid, state.x, state.z, tx, tz, 0.12,
                       (0.2, 0.3, 0.8))
    return img


ENV = Env(name="walker", reset_from=reset_from, n_uniform=3, step=step,
          render=render, action_dim=6, max_steps=MAX_STEPS)
