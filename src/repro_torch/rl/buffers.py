"""Replay buffers for the off-policy algorithms (SAC/DDPG), port of
``repro.rl.buffers``.

Two implementations with matching semantics:

* :class:`ReplayBuffer` — the host-side numpy buffer, copied from the
  reference, where it is the PARITY REFERENCE: the tests hold the device
  ring's inserts and wraparound against it bit for bit.
* :class:`DeviceReplayBuffer` — a ring on the device: uint8 pixels (like
  the numpy buffer), float32 actions, rewards and dones.  An insert is a
  slice write in place and sampling draws indices on the device, so the
  off-policy engine (``repro_torch.rl.rollout``) never round-trips a
  transition through the host.

The ring is fixed-width: every insert writes the same number of rows
``n_add`` (the engine's ``n_envs``), and ``capacity`` must be a multiple of
it, so an insert never straddles the wrap.  The write cursor ``idx`` and
the fill count ``size`` follow from the number of inserts alone, so they
are host ints: inserting and sampling never read the device.

A population's batched lanes (``repro_torch.rl.population``) keep one
ring with a leading member axis, ``(P, capacity, ...)``: every member
inserts at the same cursor (they share the static config), and
:func:`population_sample` draws each member's indices from its own
generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


class ReplayBuffer:
    """Host-side numpy buffer with uint8 pixel storage (the reference)."""

    def __init__(self, capacity: int, obs_shape: tuple, action_dim: int,
                 seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity,) + obs_shape, np.uint8)
        self.next_obs = np.zeros((capacity,) + obs_shape, np.uint8)
        self.actions = np.zeros((capacity, action_dim), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self.idx = 0
        self.full = False
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.capacity if self.full else self.idx

    @staticmethod
    def _quantize(obs):
        return np.clip(np.round(np.asarray(obs) * 255), 0, 255).astype(np.uint8)

    def add_batch(self, obs, action, reward, next_obs, done):
        """Vectorised add: leading dim = n_envs."""
        n = obs.shape[0]
        idxs = (self.idx + np.arange(n)) % self.capacity
        self.obs[idxs] = self._quantize(obs)
        self.next_obs[idxs] = self._quantize(next_obs)
        self.actions[idxs] = np.asarray(action)
        self.rewards[idxs] = np.asarray(reward)
        self.dones[idxs] = np.asarray(done, np.float32)
        self.idx = int((self.idx + n) % self.capacity)
        self.full = self.full or self.idx < n or len(self) == self.capacity
        if not self.full and self.idx == 0:
            self.full = True

    def sample(self, batch: int, *, encode_fn=None):
        """Draw a minibatch; optionally encode observations in ONE call.

        ``encode_fn`` is applied to obs and next_obs stacked into a single
        (2*batch, ...) array; the features come back under ``obs_feats`` /
        ``next_obs_feats`` alongside the raw pixels.
        """
        idxs = self.rng.integers(0, len(self), size=batch)
        out = {
            "obs": self.obs[idxs].astype(np.float32) / 255.0,
            "next_obs": self.next_obs[idxs].astype(np.float32) / 255.0,
            "actions": self.actions[idxs],
            "rewards": self.rewards[idxs],
            "dones": self.dones[idxs],
        }
        if encode_fn is not None:
            stacked = np.concatenate([out["obs"], out["next_obs"]])
            feats = np.asarray(encode_fn(stacked))
            out["obs_feats"], out["next_obs_feats"] = \
                feats[:batch], feats[batch:]
        return out


# ---------------------------------------------------------------------------
# Device ring
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceReplayBuffer:
    """Ring of transitions on the device.  Construct with
    :func:`device_buffer`; :func:`buffer_add_u8` writes its storage in
    place and returns the buffer with the cursor moved."""

    obs: Any                      # (capacity, *obs_shape) uint8
    next_obs: Any                 # (capacity, *obs_shape) uint8
    actions: Any                  # (capacity, action_dim) float32
    rewards: Any                  # (capacity,) float32
    dones: Any                    # (capacity,) float32
    idx: int                      # next write cursor
    size: int                     # filled rows
    n_add: int                    # fixed insert width

    @property
    def capacity(self) -> int:
        return self.rewards.shape[-1]


def device_buffer(capacity: int, obs_shape: tuple, action_dim: int, *,
                  n_add: int = 1, device=None,
                  members: int | None = None) -> DeviceReplayBuffer:
    """Allocate an empty ring accepting ``n_add``-row inserts; with
    ``members`` P, one ring a member of a population, ``(P, capacity,
    ...)``."""
    if capacity % n_add != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of the "
                         f"insert width n_add={n_add} (keeps the write "
                         f"cursor slice-aligned)")
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    lead = (capacity,) if members is None else (members, capacity)
    return DeviceReplayBuffer(
        obs=torch.zeros(lead + tuple(obs_shape), dtype=torch.uint8,
                        device=dev),
        next_obs=torch.zeros(lead + tuple(obs_shape), dtype=torch.uint8,
                             device=dev),
        actions=torch.zeros(lead + (action_dim,), device=dev),
        rewards=torch.zeros(lead, device=dev),
        dones=torch.zeros(lead, device=dev),
        idx=0, size=0, n_add=n_add)


def quantize_obs(obs: torch.Tensor) -> torch.Tensor:
    """Float [0,1] pixels -> uint8 ring storage (matches the numpy
    reference's ``ReplayBuffer._quantize``)."""
    return torch.clamp(torch.round(obs * 255), 0, 255).to(torch.uint8)


def buffer_add(buf: DeviceReplayBuffer, obs, action, reward, next_obs,
               done) -> DeviceReplayBuffer:
    """Insert ``n_add`` float-pixel transitions at the ring cursor;
    quantises obs/next_obs to uint8 like the numpy reference."""
    return buffer_add_u8(buf, quantize_obs(obs), action, reward,
                         quantize_obs(next_obs), done)


def buffer_add_u8(buf: DeviceReplayBuffer, obs_u8, action, reward,
                  next_obs_u8, done) -> DeviceReplayBuffer:
    """Insert pre-quantised (uint8) observations.

    The engine's hot path: consecutive env steps share a frame
    (``next_obs`` at t IS ``obs`` at t+1), so the engine quantises each
    frame ONCE and reuses it as the next transition's stored observation.
    One slice write per tensor, never straddling the wrap.  A
    population's ring takes ``(P, n_add, ...)`` inserts.
    """
    lead = buf.rewards.dim() - 1         # 1 for a population's ring
    n = obs_u8.shape[lead]
    if n != buf.n_add:
        raise ValueError(f"insert width {n} != buffer's fixed n_add "
                         f"{buf.n_add}")
    rows = (slice(None),) * lead + (slice(buf.idx, buf.idx + n),)
    buf.obs[rows] = obs_u8
    buf.next_obs[rows] = next_obs_u8
    buf.actions[rows] = action
    buf.rewards[rows] = reward.reshape(buf.rewards[rows].shape)
    buf.dones[rows] = done.to(torch.float32).reshape(buf.dones[rows].shape)
    cap = buf.capacity
    return dataclasses.replace(buf, idx=(buf.idx + n) % cap,
                               size=min(buf.size + n, cap))


def sample_indices(gen: torch.Generator, batch: int, size: int
                   ) -> torch.Tensor:
    """Uniform indices in [0, size) on ``gen``'s device (an empty ring
    samples row 0, as the reference's clamped range does)."""
    return torch.randint(0, max(size, 1), (batch,), generator=gen,
                         device=gen.device)


def buffer_sample(buf: DeviceReplayBuffer, batch: int,
                  gen: torch.Generator) -> dict:
    """Uniform minibatch over the filled region, on the device.

    Returns the same dict layout as :meth:`ReplayBuffer.sample` (pixels
    dequantised to float32 in [0, 1]).
    """
    idxs = sample_indices(gen, batch, buf.size)
    return {
        "obs": buf.obs[idxs].to(torch.float32) / 255.0,
        "next_obs": buf.next_obs[idxs].to(torch.float32) / 255.0,
        "actions": buf.actions[idxs],
        "rewards": buf.rewards[idxs],
        "dones": buf.dones[idxs],
    }


def population_sample(buf: DeviceReplayBuffer, batch: int, gens) -> dict:
    """:func:`buffer_sample` for every member of a population's ring, its
    indices drawn from its own generator: ``(P, batch, ...)`` tensors."""
    idxs = torch.stack([sample_indices(g, batch, buf.size) for g in gens])
    rows = torch.arange(len(gens), device=idxs.device)[:, None]
    return {
        "obs": buf.obs[rows, idxs].to(torch.float32) / 255.0,
        "next_obs": buf.next_obs[rows, idxs].to(torch.float32) / 255.0,
        "actions": buf.actions[rows, idxs],
        "rewards": buf.rewards[rows, idxs],
        "dones": buf.dones[rows, idxs],
    }


__all__ = ["ReplayBuffer", "DeviceReplayBuffer", "device_buffer",
           "buffer_add", "buffer_add_u8", "buffer_sample",
           "population_sample", "quantize_obs", "sample_indices"]
