"""Observation pipeline matching the paper's wrapper stack (§4.1), over a
batch of envs (port of ``repro.envs.wrappers``):

render 100x100 RGB -> crop to 84x84 (random crop in training, centre crop
in eval) -> float in [0,1] -> FrameStack(3) -> (N, 84, 84, 9) NHWC tensor.
For deployment/bandwidth analyses an opaque alpha channel is appended at
the (simulated) OpenGL upload boundary; training uses RGB only.

Randomness comes from an explicit ``torch.Generator`` on the env's
device, carried in the state as the reference carries its key: the crop
offsets and the auto-reset states of a step are drawn from it, or given
(``offsets=``, ``reset_inner=``) so a test can feed the reference's.
Each step computes the reset of every env and selects it with
``torch.where``, as the reference does, so a step never reads the device
from the host.

A population (``repro_torch.rl.population``) steps P members' envs at
once: states carry a ``(P, N, ...)`` axis and one generator a member,
each member's draws come from its own generator, and the P·N envs step
together through the batched functions.  Row p is bit for bit what
``reset_batch``/``step_batch`` give member p alone.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.envs.base import Env

RENDER_RES = 100
CROP = 84
STACK = 3


class PixelEnvState(NamedTuple):
    inner: object                 # the env's state, (N, ...) tensors
    frames: torch.Tensor          # (N, STACK, CROP, CROP, 3) float32
    gen: torch.Generator          # draws crops and resets
    episode_return: torch.Tensor  # (N,) float32
    step_count: torch.Tensor      # (N,) int32


def crop(frames: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
         size: int = CROP) -> torch.Tensor:
    """``(N, R, R, 3)`` frames -> each env's ``(size, size)`` window at
    ``(oy[n], ox[n])``, as ``lax.dynamic_slice`` cuts it."""
    n = frames.shape[0]
    span = torch.arange(size, device=frames.device)
    rows = (oy[:, None] + span)[:, :, None]
    cols = (ox[:, None] + span)[:, None, :]
    return frames[torch.arange(n, device=frames.device)[:, None, None],
                  rows, cols]


def _obs(frames):
    """(N, STACK, H, W, 3) -> (N, H, W, 3*STACK) channel-stacked obs."""
    n, s, h, w, c = frames.shape
    return frames.permute(0, 2, 3, 1, 4).reshape(n, h, w, s * c)


def _select(done, a, b):
    """Env by env, ``a`` where ``done`` else ``b`` (NamedTuples of
    ``(N, ...)`` tensors)."""
    def pick(x, y):
        d = done.reshape(done.shape + (1,) * (x.dim() - 1))
        return torch.where(d, x, y)
    return type(a)(*(pick(x, y) for x, y in zip(a, b)))


def _map_state(fn, state: PixelEnvState, gen) -> PixelEnvState:
    """``fn`` applied to every tensor of ``state``, with ``gen`` for its
    generator(s)."""
    return PixelEnvState(type(state.inner)(*map(fn, state.inner)),
                         fn(state.frames), gen, fn(state.episode_return),
                         fn(state.step_count))


def _members(state: PixelEnvState, P: int) -> PixelEnvState:
    """Split the leading P·N axis of a flat state into ``(P, N)``."""
    return _map_state(lambda x: x.unflatten(0, (P, x.shape[0] // P)), state,
                      state.gen)


class PixelEnv:
    """Wraps a batched state-based Env into the paper's pixel pipeline."""

    def __init__(self, env: Env, *, train: bool = True):
        self.env = env
        self.train = train
        self.obs_shape = (CROP, CROP, 3 * STACK)
        self.action_dim = env.action_dim

    def offsets(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """(N, 2) crop offsets (oy, ox): uniform in [0, 16] in training,
        the centre crop at eval."""
        if self.train:
            return torch.randint(0, RENDER_RES - CROP + 1, (n, 2),
                                 generator=gen, device=gen.device)
        return torch.full((n, 2), (RENDER_RES - CROP) // 2,
                          device=gen.device, dtype=torch.int64)

    def frame(self, inner, offsets: torch.Tensor) -> torch.Tensor:
        """The cropped render of ``inner``: the full frame's window at
        ``offsets``, drawn directly (bit for bit the crop of the 100x100
        frame)."""
        return self.env.render(inner, (offsets[:, 0], offsets[:, 1], CROP))

    # -- batched (vectorised-env) API ---------------------------------------
    def reset_batch(self, gen: torch.Generator, n: int):
        """``n`` fresh envs -> (states, (N, H, W, C) obs).  Draws the
        reset states, then the crop offsets, from ``gen``."""
        inner = self.env.reset(gen, n)
        return self._start(inner, self.offsets(gen, n), gen)

    def _start(self, inner, offsets, gen):
        frame = self.frame(inner, offsets)
        n = frame.shape[0]
        frames = frame[:, None].expand(n, STACK, *frame.shape[1:])
        dev = frame.device
        state = PixelEnvState(inner, frames, gen,
                              torch.zeros(n, device=dev),
                              torch.zeros(n, dtype=torch.int32, device=dev))
        return state, _obs(frames)

    def step_batch(self, states: PixelEnvState, actions: torch.Tensor, *,
                   offsets: Optional[torch.Tensor] = None, reset_inner=None):
        """(states, (N, A)) -> (states, (N, H, W, C) obs, (N,) reward,
        (N,) done).  Draws the crop offsets, then the reset states, from
        ``states.gen`` unless given; a done env restarts from its reset
        state (its frame stack filled with the reset frame)."""
        n = actions.shape[0]
        gen = states.gen
        if offsets is None:
            offsets = self.offsets(gen, n)
        if reset_inner is None:
            reset_inner = self.env.reset(gen, n)
        inner, reward, done = self.env.step(states.inner, actions)
        frame = self.frame(inner, offsets)
        frames = torch.cat([states.frames[:, 1:], frame[:, None]], dim=1)

        # auto-reset on done (standard vectorised-env semantics)
        reset_frame = self.frame(reset_inner, offsets)
        inner = _select(done, reset_inner, inner)
        frames = torch.where(done[:, None, None, None, None],
                             reset_frame[:, None], frames)

        ep_ret = torch.where(done, 0.0, states.episode_return + reward)
        steps = torch.where(done, 0, states.step_count + 1)
        new = PixelEnvState(inner, frames, gen, ep_ret,
                            steps.to(torch.int32))
        return new, _obs(frames), reward, done

    # -- population-batched API ---------------------------------------------
    def reset_population(self, gens, n: int):
        """``n`` fresh envs for each of the P members whose generators are
        ``gens`` -> (states with ``(P, N, ...)`` tensors and the
        generators, ``(P, N, H, W, C)`` obs).  Member p draws its reset
        states, then its crop offsets, from ``gens[p]``, as
        ``reset_batch(gens[p], n)`` does."""
        draws = [(self.env.draw(g, n), self.offsets(g, n)) for g in gens]
        state, obs = self._start(
            self.env.reset_from(torch.cat([u for u, _ in draws])),
            torch.cat([o for _, o in draws]), tuple(gens))
        return _members(state, len(gens)), obs.unflatten(0, (len(gens), n))

    def step_population(self, states: PixelEnvState, actions: torch.Tensor):
        """(population states, ``(P, N, A)`` actions) -> (states, ``(P, N,
        H, W, C)`` obs, ``(P, N)`` reward, ``(P, N)`` done).  Member p
        draws its crop offsets, then its reset states, from its own
        generator, as ``step_batch`` does."""
        P, n = actions.shape[:2]
        draws = [(self.offsets(g, n), self.env.draw(g, n))
                 for g in states.gen]
        flat = _map_state(lambda x: x.flatten(0, 1), states, None)
        new, obs, reward, done = self.step_batch(
            flat, actions.flatten(0, 1),
            offsets=torch.cat([o for o, _ in draws]),
            reset_inner=self.env.reset_from(torch.cat([u for _, u in
                                                       draws])))
        new = _members(new._replace(gen=states.gen), P)
        return (new, obs.unflatten(0, (P, n)), reward.unflatten(0, (P, n)),
                done.unflatten(0, (P, n)))

    # -- deployment boundary -------------------------------------------------
    @staticmethod
    def to_rgba_uint8(obs: torch.Tensor) -> torch.Tensor:
        """Simulated OpenGL upload: append opaque alpha, quantise to uint8.
        obs: (..., H, W, 3*STACK) float -> (..., H, W, 4*STACK) uint8."""
        *lead, h, w, c = obs.shape
        rgb = obs.reshape(*lead, h, w, STACK, 3)
        alpha = torch.ones((*lead, h, w, STACK, 1), device=obs.device)
        rgba = torch.cat([rgb, alpha], dim=-1).reshape(*lead, h, w,
                                                       4 * STACK)
        return torch.clamp(torch.round(rgba * 255), 0, 255).to(torch.uint8)


def make_pixel_env(name: str, *, train: bool = True) -> PixelEnv:
    from repro_torch.envs import REGISTRY
    return PixelEnv(REGISTRY[name], train=train)


__all__ = ["CROP", "PixelEnv", "PixelEnvState", "RENDER_RES", "STACK",
           "crop", "make_pixel_env"]
