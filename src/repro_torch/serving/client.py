"""Edge-client execution and the end-to-end decision loop (port of
``repro.serving.client``).

Each client encodes and transmits ONE frame per decision; micro-batching
happens server-side across clients.  The batched encode path
(:meth:`EdgeClient.measure_batch`) runs B frames through one launch of the
fused encoder kernel.  :class:`DecisionLoop` composes client, link and
server into the paper's Figure-5 pipeline from supplied stage times.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.netsim import ShapedLink
from repro_torch.serving.server import _block


@dataclasses.dataclass
class EdgeClient:
    """encode_fn(obs) -> payload dict; wire_bytes = bytes on the link."""

    encode_fn: Callable
    wire_bytes: int
    encode_time_s: Optional[float] = None

    def measure(self, example_obs, *, iters: int = 20,
                warmup: int = 2) -> float:
        # warm-up blocked BEFORE the clock starts: launches are
        # asynchronous, so unfinished warm-up work would skew the timing
        out = self.encode_fn(example_obs)
        for _ in range(warmup):
            out = self.encode_fn(example_obs)
        _block(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.encode_fn(example_obs)
        _block(out)
        self.encode_time_s = (time.perf_counter() - t0) / iters
        return self.encode_time_s

    def measure_batch(self, example_obs, *, batch: int = 8,
                      iters: int = 10, warmup: int = 2) -> float:
        """Per-frame encode time when ``batch`` frames share one launch.

        ``example_obs`` is a single (1, H, W, C) observation, tiled along
        the leading axis.  Returns seconds PER FRAME, comparable to
        :meth:`measure`.
        """
        obs = example_obs[:1].expand(
            (batch,) + tuple(example_obs.shape[1:])).contiguous()
        out = self.encode_fn(obs)
        for _ in range(warmup):
            out = self.encode_fn(obs)
        _block(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.encode_fn(obs)
        _block(out)
        return (time.perf_counter() - t0) / (iters * batch)


@dataclasses.dataclass
class DecisionLoop:
    """One client against one server over a shaped link.

    ``split=True``  : obs -> edge encode -> tx(features) -> server head
    ``split=False`` : obs -> tx(raw frame) -> server (encoder + head)
    """

    link: ShapedLink
    server_time_s: float
    split: bool
    edge_time_s: float = 0.0
    payload_bytes: int = 0
    action_bytes: int = 64

    def decision_latency(self) -> float:
        t = 0.0
        if self.split:
            t += self.edge_time_s
        tr = self.link.send(t, self.payload_bytes)
        t = tr.arrival + self.server_time_s
        t += self.link.tx_time(self.action_bytes) + self.link.propagation_s
        return t

    def run(self, n_decisions: int = 1000) -> np.ndarray:
        """Sequential closed-loop decisions (the RL setting: the next
        observation exists only after the action returns)."""
        self.link.reset()
        lats = []
        for _ in range(n_decisions):
            lats.append(self.decision_latency())
            self.link.reset()   # closed loop: link idle between decisions
        return np.asarray(lats)

    def median_latency(self, n_decisions: int = 1000) -> float:
        return float(np.median(self.run(n_decisions)))


__all__ = ["DecisionLoop", "EdgeClient"]
