"""Edge-client execution (port of ``repro.serving.client.EdgeClient``).

Each client encodes and transmits ONE frame per decision; micro-batching
happens server-side across clients.  The batched encode path
(:meth:`EdgeClient.measure_batch`) runs B frames through one launch of the
fused encoder kernel.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

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


__all__ = ["EdgeClient"]
