"""Server-side policy execution (port of ``repro.serving.server``).

``PolicyServer`` wraps a server-half function and measures its service
time.  ``BatchingPolicyServer`` serves queued requests as ONE batched call
(up to ``max_batch``) and measures the service-time curve t(B) that
:class:`BatchServiceModel` interpolates.  Timings wait for the device with
:func:`_block` before reading the host clock on both sides of the window.
The queue simulators come with the fleet.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class PolicyServer:
    """serve_fn(payload) -> action; service_time_s measured if not given."""

    serve_fn: Callable
    service_time_s: Optional[float] = None

    def measure(self, example_payload, *, iters: int = 20,
                warmup: int = 2) -> float:
        # warm up, blocked before the clock starts: kernel launches are
        # asynchronous, so unfinished warm-up work would bleed into the
        # timed region
        out = self.serve_fn(example_payload)
        for _ in range(warmup):
            out = self.serve_fn(example_payload)
        _block(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.serve_fn(example_payload)
        _block(out)
        self.service_time_s = (time.perf_counter() - t0) / iters
        return self.service_time_s


def _block(x=None):
    """Wait until the device has finished the work queued so far (the
    work that produced ``x``).  A no-op when CUDA was never used."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class BatchServiceModel:
    """Measured batched service-time curve t(B), piecewise-linear.

    ``points`` are (batch_size, seconds) samples sorted by batch size;
    queries between samples interpolate.  Queries past the largest
    measured sample are OUT OF RANGE and handled per ``out_of_range``:
    ``"extrapolate"`` (default, with the last segment's marginal cost,
    warning once), ``"clamp"`` (t(max measured B), warning once) or
    ``"raise"``.
    """

    points: tuple[tuple[int, float], ...]
    out_of_range: str = "extrapolate"
    _warned: bool = dataclasses.field(default=False, compare=False,
                                      repr=False)

    def __post_init__(self):
        if not self.points:
            raise ValueError("BatchServiceModel needs >= 1 measured point")
        bs = [b for b, _ in self.points]
        if bs != sorted(set(bs)):
            raise ValueError(f"points must be sorted/unique in batch: {bs}")
        if self.out_of_range not in ("extrapolate", "clamp", "raise"):
            raise ValueError(f"out_of_range must be extrapolate|clamp|raise,"
                             f" got {self.out_of_range!r}")

    @property
    def max_measured_batch(self) -> int:
        """Largest batch size the curve was actually measured at."""
        return self.points[-1][0]

    def _out_of_range(self, batch: int) -> float:
        bs = np.array([b for b, _ in self.points], float)
        ts = np.array([t for _, t in self.points], float)
        if self.out_of_range == "raise":
            raise ValueError(
                f"t({batch}) is beyond the measured range (largest "
                f"measured B={self.max_measured_batch}); re-measure with "
                f"larger batch_sizes or use out_of_range='extrapolate'")
        if not self._warned:
            object.__setattr__(self, "_warned", True)
            how = ("clamped to t(max)" if self.out_of_range == "clamp"
                   else "extrapolated")
            warnings.warn(
                f"BatchServiceModel: t({batch}) queried beyond the measured "
                f"range (largest measured B={self.max_measured_batch}); "
                f"{how}, not a measurement",
                RuntimeWarning, stacklevel=3)
        if self.out_of_range == "clamp":
            return float(ts[-1])
        if len(bs) > 1:
            slope = (ts[-1] - ts[-2]) / (bs[-1] - bs[-2])
        else:
            slope = ts[-1] / bs[-1]
        return float(ts[-1] + slope * (batch - bs[-1]))

    def __call__(self, batch: int) -> float:
        bs = np.array([b for b, _ in self.points], float)
        ts = np.array([t for _, t in self.points], float)
        if batch <= bs[-1]:
            return float(np.interp(batch, bs, ts))
        return self._out_of_range(batch)


@dataclasses.dataclass
class BatchingPolicyServer:
    """Micro-batching policy server.

    ``serve_batch_fn`` maps a stacked micro-batch payload (every tensor
    gains a leading batch axis; see ``repro_torch.core.wire.
    stack_payloads``) to stacked actions.  ``measure`` times it across
    batch sizes, yielding the t(B) curve; ``max_batch`` / ``max_wait_s``
    are the batching policy.
    """

    serve_batch_fn: Callable
    max_batch: int = 8
    max_wait_s: float = 0.0
    service_times_s: Optional[dict[int, float]] = None

    def serve(self, payloads: Sequence) -> list:
        """Serve queued single-request payloads as ONE batched call."""
        from repro_torch.core.wire import stack_payloads
        if len(payloads) > self.max_batch:
            raise ValueError(f"{len(payloads)} requests > max_batch "
                             f"{self.max_batch}")
        out = self.serve_batch_fn(stack_payloads(payloads))
        return [out[i] for i in range(len(payloads))]

    def measure(self, example_payload, *,
                batch_sizes: Sequence[int] = (1, 2, 4, 8),
                iters: int = 10, warmup: int = 2) -> dict[int, float]:
        """Measure t(B) on this device for each micro-batch size."""
        times: dict[int, float] = {}
        for b in sorted(set(batch_sizes)):
            batch = {k: v[None].expand((b,) + tuple(v.shape)).contiguous()
                     for k, v in example_payload.items()}
            out = self.serve_batch_fn(batch)
            for _ in range(warmup):
                out = self.serve_batch_fn(batch)
            _block(out)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = self.serve_batch_fn(batch)
            _block(out)
            times[b] = (time.perf_counter() - t0) / iters
        self.service_times_s = times
        return times

    def service_model(self, *,
                      out_of_range: str = "extrapolate") -> BatchServiceModel:
        if not self.service_times_s:
            raise ValueError("call measure() first")
        return BatchServiceModel(tuple(sorted(self.service_times_s.items())),
                                 out_of_range=out_of_range)


__all__ = ["BatchServiceModel", "BatchingPolicyServer", "PolicyServer"]
