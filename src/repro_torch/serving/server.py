"""Server-side policy execution (port of ``repro.serving.server``).

``PolicyServer`` wraps a server-half function and measures its service
time.  ``BatchingPolicyServer`` serves queued requests as ONE batched call
(up to ``max_batch``) and measures the service-time curve t(B) that
:class:`BatchServiceModel` interpolates.  Timings wait for the device with
:func:`_block` before reading the host clock on both sides of the window.

``QueueSim`` reproduces the paper's Table 6 setting: N clients at a fixed
decision rate against one FIFO server, reporting p95 decision latency
(queueing + service + transfer).  ``BatchQueueSim`` extends it with
micro-batching: when the server frees up it launches whatever has arrived
(capped at ``max_batch``), optionally holding the batch open
``max_wait_s`` for stragglers, and charges the whole batch the batched
service time t(B).  The simulators take times as Python floats and do
plain float and numpy arithmetic, so equal inputs give the reference's
latencies bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.netsim import ShapedLink


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


@dataclasses.dataclass
class QueueSim:
    """Deterministic FIFO queue: N clients, fixed rate, one server.

    Decision latency per request = uplink transfer + queueing + service +
    downlink transfer.  ``max_clients`` sweeps N until p95 exceeds the
    budget (the paper's Table 6 protocol: 10 Hz, p95 < 100 ms).
    """

    service_time_s: float
    uplink: ShapedLink
    payload_bytes: int
    action_bytes: int = 64
    rate_hz: float = 10.0
    horizon_s: float = 10.0

    def _request_arrivals(self, n_clients: int) \
            -> list[tuple[float, float, int]]:
        """(t_obs, server_arrival, client) per request, observation order.

        The uplink serialises transfers FIFO, so arrivals are
        non-decreasing in this order.
        """
        self.uplink.reset()
        period = 1.0 / self.rate_hz
        events = []          # (obs_time, client)
        for c in range(n_clients):
            t = c * period / n_clients       # staggered clients
            while t < self.horizon_s:
                events.append((t, c))
                t += period
        events.sort()
        return [(t_obs, self.uplink.send(t_obs, self.payload_bytes).arrival,
                 c) for t_obs, c in events]

    def _drain_downlink(self, done: float, n_actions: int,
                        down_free: float) -> tuple[list[float], float]:
        """Receive times of ``n_actions`` actions completing at ``done``.

        The action return rides the same link model (downlink assumed
        symmetric), but the downlink SERIALISES: each action payload
        transmits after the previous one (and after whatever the link was
        still sending), so a batch of B actions costs B transfer slots,
        not one.  Returns (per-action receive times, new downlink-busy
        time).
        """
        act_tx = self.uplink.tx_time(self.action_bytes)
        start = max(done, down_free)
        recv = [start + (m + 1) * act_tx + self.uplink.propagation_s
                for m in range(n_actions)]
        return recv, start + n_actions * act_tx

    def latencies(self, n_clients: int) -> np.ndarray:
        server_free = 0.0
        down_free = 0.0
        lat = []
        for t_obs, arrival, _ in self._request_arrivals(n_clients):
            start = max(arrival, server_free)
            done = start + self.service_time_s
            server_free = done
            (recv,), down_free = self._drain_downlink(done, 1, down_free)
            lat.append(recv - t_obs)
        return np.asarray(lat)

    def p95(self, n_clients: int) -> float:
        return float(np.percentile(self.latencies(n_clients), 95))

    def _zero_scan_limit(self, p95_budget_s: float) -> int:
        """How far past a failing p95 to keep scanning while NOTHING has
        passed yet.  FIFO p95 is monotone in N, so a failure at N=1
        means saturation: 0.  Batch-hold subclasses override — their
        p95 dips after small N."""
        return 0

    def max_clients(self, *, p95_budget_s: float = 0.1,
                    n_max: int = 512) -> int:
        best = 0
        limit = self._zero_scan_limit(p95_budget_s)
        for n in range(1, n_max + 1):
            if self.p95(n) <= p95_budget_s:
                best = n
            elif best or n >= limit:
                # monotone beyond saturation — stop, even at best == 0
                # (p95(1) already over budget) once past the small-N
                # transient window
                break
        return best


@dataclasses.dataclass
class BatchQueueSim(QueueSim):
    """Micro-batching server against the same client population.

    When the server frees up it launches a batch: all requests that have
    arrived (up to ``max_batch``), after optionally holding the launch up
    to ``max_wait_s`` for the batch to fill.  The whole batch occupies the
    server for ``service_model(B)`` (falling back to the batch-invariant
    ``service_time_s`` when no model is given); the B actions then
    serialise on the downlink, each charged its own transfer slot.  With
    ``max_batch=1``/``max_wait_s=0`` this reduces exactly to the FIFO
    :class:`QueueSim`.
    """

    max_batch: int = 8
    max_wait_s: float = 0.0
    service_model: Optional[Callable[[int], float]] = None

    def service(self, batch: int) -> float:
        if self.service_model is not None:
            return self.service_model(batch)
        return self.service_time_s

    def _zero_scan_limit(self, p95_budget_s: float) -> int:
        """With a batch hold, p95 is NOT monotone at small N: a lone
        client waits out ``max_wait_s`` every decision, so p95(1) can
        exceed a budget that a well-fed batching server meets easily.
        Holds stop binding once ~max_batch requests arrive within the
        relevant window (the hold, or the budget when that is tighter),
        so keep scanning past zero until twice that population."""
        if self.max_wait_s <= 0.0 or p95_budget_s <= 0.0:
            return 0
        window = min(self.max_wait_s, p95_budget_s)
        return int(np.ceil(2.0 * self.max_batch / (self.rate_hz * window)))

    def latencies(self, n_clients: int) -> np.ndarray:
        arr = self._request_arrivals(n_clients)
        n = len(arr)
        server_free = 0.0
        down_free = 0.0
        lat = np.empty(n)
        i = 0
        while i < n:
            ready = max(server_free, arr[i][1])
            j_fill = i + self.max_batch - 1
            if j_fill < n and arr[j_fill][1] <= ready:
                launch = ready           # batch already full when server free
            elif self.max_wait_s > 0.0:
                deadline = ready + self.max_wait_s
                fill = arr[j_fill][1] if j_fill < n else np.inf
                launch = max(ready, min(deadline, fill))
            else:
                launch = ready           # greedy: take what's there
            k = i
            while k < n and k - i < self.max_batch and arr[k][1] <= launch:
                k += 1
            done = launch + self.service(k - i)
            # B actions serialise on the downlink — the batch does NOT
            # collapse into one action transfer
            recv, down_free = self._drain_downlink(done, k - i, down_free)
            for m in range(i, k):
                lat[m] = recv[m - i] - arr[m][0]
            server_free = done
            i = k
        return lat


__all__ = ["BatchQueueSim", "BatchServiceModel", "BatchingPolicyServer",
           "PolicyServer", "QueueSim"]
