"""Deterministic bandwidth-shaped link simulation (port of
``repro.serving.netsim``).

Stands in for the paper's ``tc netem``-shaped physical link: a serialising
link with finite bandwidth, fixed propagation delay and (optional)
deterministic jitter.  Transfers are serialised FIFO, so a transfer cannot
start before the previous one finished (a token bucket with a one-burst
depth, which is what bandwidth shaping does to a single TCP flow).

Jitter (as ``tc netem delay ... jitter``) is extra PROPAGATION delay on one
transfer's arrival and never occupies the link, so back-to-back transfers
still serialise at exactly ``tx_time`` spacing.  The deterministic
per-transfer pattern cycles 0.5x / 1.0x / 1.5x of ``jitter_s``, so the mean
added delay is exactly ``jitter_s``; with nonzero jitter arrival order can
differ from send order.  The queue simulators all run jitter-free links.

The scenario engine's adversarial links share ``ShapedLink``'s interface
(``send(t, payload_bytes) -> LinkTrace``, ``tx_time``, ``reset()``):

``TraceLink``
    Trace-driven piecewise-constant bandwidth; transfers integrate bits
    across regime boundaries, so a payload straddling a dropout pays for
    it exactly.
``MarkovLink``
    Seeded Markov regime switching (Wi-Fi rate adaptation): the link
    dwells ``dwell_s`` in one of a few rates and hops by a row-stochastic
    transition matrix.
``LossyLink``
    Seeded Bernoulli loss with retransmit after an RTO gap (head-of-line
    blocking, as for one in-order TCP flow).
``StochasticJitterLink``
    ``ShapedLink`` whose jitter draw is seeded-uniform on
    ``[0, 2 * jitter_s)`` instead of the deterministic cycle.

Every stochastic link draws from a numpy ``Generator`` seeded with its
``seed``, as the reference seeds it, and ``reset()`` restores the full
initial state including the generator, so one link replays the identical
trace across simulator runs.  ``LINK_KINDS`` / ``make_link`` name link
shapes for the Scenario schema.  Pure float and numpy arithmetic: equal
inputs and seeds give the reference's traces bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class LinkTrace:
    start: float
    tx_done: float
    arrival: float
    payload_bytes: int


@dataclasses.dataclass
class ShapedLink:
    bandwidth_bps: float             # shaped bandwidth, bits/s
    propagation_s: float = 0.002     # one-way propagation delay
    jitter_s: float = 0.0            # deterministic per-transfer jitter
    _busy_until: float = 0.0
    _n: int = 0

    def tx_time(self, payload_bytes: int) -> float:
        return 8.0 * payload_bytes / self.bandwidth_bps

    def _jitter(self) -> float:
        """Per-transfer arrival jitter draw; mean is exactly ``jitter_s``."""
        return self.jitter_s * (0.5 + 0.5 * (self._n % 3))

    def send(self, t: float, payload_bytes: int) -> LinkTrace:
        """Enqueue a transfer at time ``t``; returns timing trace.

        Jitter delays THIS transfer's arrival only — it never extends the
        link's busy window, so it cannot double-count into the
        serialisation of subsequent transfers.
        """
        start = max(t, self._busy_until)
        tx_done = start + self.tx_time(payload_bytes)
        self._busy_until = tx_done
        jitter = self._jitter()
        self._n += 1
        return LinkTrace(start=start, tx_done=tx_done,
                         arrival=tx_done + self.propagation_s + jitter,
                         payload_bytes=payload_bytes)

    def reset(self) -> None:
        self._busy_until = 0.0
        self._n = 0


MBPS = 1e6


def shaped(mbps: float, *, rtt_ms: float = 4.0) -> ShapedLink:
    return ShapedLink(bandwidth_bps=mbps * MBPS,
                      propagation_s=rtt_ms / 2000.0)


@dataclasses.dataclass
class StochasticJitterLink(ShapedLink):
    """``ShapedLink`` with a seeded-uniform jitter draw on
    ``[0, 2 * jitter_s)`` — same ``jitter_s`` mean as the deterministic
    cycle, netem-style delay variation on arrival only."""
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _jitter(self) -> float:
        return float(self._rng.uniform(0.0, 2.0 * self.jitter_s))

    def reset(self) -> None:
        super().reset()
        self._rng = np.random.default_rng(self.seed)


def _integrate_tx(bw_at: Callable[[float], float],
                  next_boundary: Callable[[float], float],
                  start: float, bits: float) -> float:
    """Finish time of a ``bits`` transfer starting at ``start`` under a
    piecewise-constant bandwidth ``bw_at(t)`` whose next regime boundary
    after ``t`` is ``next_boundary(t)`` (``inf`` for the final regime)."""
    t = start
    remaining = float(bits)
    while remaining > 0.0:
        bps = bw_at(t)
        bound = next_boundary(t)
        if bound == np.inf:
            if bps <= 0.0:
                raise ValueError("final link regime must have positive "
                                 "bandwidth (transfer would never finish)")
            return t + remaining / bps
        if bps > 0.0:
            capacity = bps * (bound - t)
            if capacity >= remaining:
                return t + remaining / bps
            remaining -= capacity
        t = bound
    return t


@dataclasses.dataclass
class TraceLink:
    """Trace-driven piecewise-constant bandwidth (dropouts, congestion
    windows).  ``schedule`` is ``((t_start_s, bandwidth_bps), ...)``,
    sorted, starting at t=0; the final segment extends forever.  Segments
    may have zero bandwidth (full outage) except the last.

    ``tx_time`` reports the transfer time at the NOMINAL (peak) rate —
    it is the downlink/action accounting hook, and the scenario engine
    deliberately applies the adversarial shaping to the uplink only,
    where the fat feature payloads flow.
    """
    schedule: tuple
    propagation_s: float = 0.002
    jitter_s: float = 0.0
    _busy_until: float = 0.0
    _n: int = 0

    def __post_init__(self):
        sched = tuple((float(t), float(b)) for t, b in self.schedule)
        if not sched:
            raise ValueError("TraceLink needs a non-empty schedule")
        if sched[0][0] != 0.0:
            raise ValueError("TraceLink schedule must start at t=0, got "
                             f"{sched[0][0]}")
        for (t0, _), (t1, _) in zip(sched, sched[1:]):
            if t1 <= t0:
                raise ValueError("TraceLink schedule times must be "
                                 f"strictly increasing, got {t0} -> {t1}")
        if any(b < 0.0 for _, b in sched):
            raise ValueError("TraceLink bandwidths must be >= 0")
        if sched[-1][1] <= 0.0:
            raise ValueError("TraceLink final segment must have positive "
                             "bandwidth")
        self.schedule = sched

    @property
    def nominal_bps(self) -> float:
        return max(b for _, b in self.schedule)

    def bandwidth_at(self, t: float) -> float:
        bps = self.schedule[0][1]
        for t0, b in self.schedule:
            if t0 > t:
                break
            bps = b
        return bps

    def _next_boundary(self, t: float) -> float:
        for t0, _ in self.schedule:
            if t0 > t:
                return t0
        return np.inf

    def tx_time(self, payload_bytes: int) -> float:
        return 8.0 * payload_bytes / self.nominal_bps

    def _jitter(self) -> float:
        return self.jitter_s * (0.5 + 0.5 * (self._n % 3))

    def send(self, t: float, payload_bytes: int) -> LinkTrace:
        start = max(t, self._busy_until)
        tx_done = _integrate_tx(self.bandwidth_at, self._next_boundary,
                                start, 8.0 * payload_bytes)
        self._busy_until = tx_done
        jitter = self._jitter()
        self._n += 1
        return LinkTrace(start=start, tx_done=tx_done,
                         arrival=tx_done + self.propagation_s + jitter,
                         payload_bytes=payload_bytes)

    def reset(self) -> None:
        self._busy_until = 0.0
        self._n = 0


@dataclasses.dataclass
class MarkovLink:
    """Seeded Markov regime-switching link (Wi-Fi rate-adaptation style).

    The link dwells ``dwell_s`` in one of ``states_bps`` and hops
    according to the row-stochastic ``transition`` matrix.  The state
    chain is generated lazily but strictly in chain order from one seeded
    generator, so the realised trace depends only on ``seed`` — never on
    the query pattern — and ``reset()`` replays it bitwise.
    """
    states_bps: tuple
    transition: tuple
    dwell_s: float = 0.25
    start_state: int = 0
    seed: int = 0
    propagation_s: float = 0.002
    jitter_s: float = 0.0

    def __post_init__(self):
        self.states_bps = tuple(float(b) for b in self.states_bps)
        if not self.states_bps or any(b <= 0.0 for b in self.states_bps):
            raise ValueError("MarkovLink states must all have positive "
                             "bandwidth (the lowest Wi-Fi MCS still moves "
                             "bits)")
        n = len(self.states_bps)
        rows = tuple(tuple(float(p) for p in row) for row in self.transition)
        if len(rows) != n or any(len(r) != n for r in rows):
            raise ValueError(f"transition must be {n}x{n}")
        for row in rows:
            if any(p < 0.0 for p in row) or abs(sum(row) - 1.0) > 1e-9:
                raise ValueError(f"transition rows must be stochastic: {row}")
        self.transition = rows
        if not 0 <= self.start_state < n:
            raise ValueError(f"start_state {self.start_state} out of range")
        if self.dwell_s <= 0.0:
            raise ValueError("dwell_s must be positive")
        self.reset()

    def reset(self) -> None:
        self._busy_until = 0.0
        self._n = 0
        self._rng = np.random.default_rng(self.seed)
        self._chain = [self.start_state]

    def _state_at(self, i: int) -> int:
        while len(self._chain) <= i:
            row = self.transition[self._chain[-1]]
            nxt = int(self._rng.choice(len(self.states_bps), p=row))
            self._chain.append(nxt)
        return self._chain[i]

    @property
    def nominal_bps(self) -> float:
        return max(self.states_bps)

    def bandwidth_at(self, t: float) -> float:
        return self.states_bps[self._state_at(max(0, int(t / self.dwell_s)))]

    def _next_boundary(self, t: float) -> float:
        return (int(t / self.dwell_s) + 1) * self.dwell_s

    def tx_time(self, payload_bytes: int) -> float:
        return 8.0 * payload_bytes / self.nominal_bps

    def _jitter(self) -> float:
        return self.jitter_s * (0.5 + 0.5 * (self._n % 3))

    def send(self, t: float, payload_bytes: int) -> LinkTrace:
        start = max(t, self._busy_until)
        tx_done = _integrate_tx(self.bandwidth_at, self._next_boundary,
                                start, 8.0 * payload_bytes)
        self._busy_until = tx_done
        jitter = self._jitter()
        self._n += 1
        return LinkTrace(start=start, tx_done=tx_done,
                         arrival=tx_done + self.propagation_s + jitter,
                         payload_bytes=payload_bytes)


@dataclasses.dataclass
class LossyLink:
    """Seeded Bernoulli loss with retransmit on a fixed-rate link.

    Each attempt occupies the link for the payload's ``tx_time``; a lost
    attempt waits ``rto_s`` and retransmits.  The link stays busy through
    the RTO gaps (head-of-line blocking: one in-order TCP flow).  After
    ``max_retries`` losses the transfer is delivered anyway — the sim
    models latency, not permanent failure.
    """
    bandwidth_bps: float
    loss_p: float = 0.0
    rto_s: float = 0.05
    max_retries: int = 8
    seed: int = 0
    propagation_s: float = 0.002

    def __post_init__(self):
        if not 0.0 <= self.loss_p < 1.0:
            raise ValueError(f"loss_p must be in [0, 1), got {self.loss_p}")
        self.reset()

    def reset(self) -> None:
        self._busy_until = 0.0
        self._n = 0
        self._rng = np.random.default_rng(self.seed)

    def tx_time(self, payload_bytes: int) -> float:
        return 8.0 * payload_bytes / self.bandwidth_bps

    def send(self, t: float, payload_bytes: int) -> LinkTrace:
        start = max(t, self._busy_until)
        tx = self.tx_time(payload_bytes)
        end = start + tx
        for _ in range(self.max_retries):
            if float(self._rng.random()) >= self.loss_p:
                break
            end = end + self.rto_s + tx    # retransmit after the RTO gap
        self._busy_until = end
        self._n += 1
        return LinkTrace(start=start, tx_done=end,
                         arrival=end + self.propagation_s,
                         payload_bytes=payload_bytes)


# --- link-kind registry (the Scenario schema names link shapes by kind) ---

LINK_KINDS: dict[str, Callable] = {}


def register_link_kind(name: str, builder: Callable) -> None:
    """``builder(seed, params: dict) -> link``; params are JSON-shaped."""
    LINK_KINDS[name] = builder


def make_link(kind: str, *, seed: int = 0, **params):
    """Build a registered link kind.  Seeded kinds receive ``seed`` unless
    ``params`` explicitly overrides it; static kinds ignore it."""
    if kind not in LINK_KINDS:
        raise KeyError(f"unknown link kind {kind!r}; registered: "
                       f"{sorted(LINK_KINDS)}")
    return LINK_KINDS[kind](seed, dict(params))


register_link_kind("static", lambda seed, p: ShapedLink(**p))
register_link_kind("trace", lambda seed, p: TraceLink(**p))
register_link_kind("markov",
                   lambda seed, p: MarkovLink(**{"seed": seed, **p}))
register_link_kind("lossy",
                   lambda seed, p: LossyLink(**{"seed": seed, **p}))
register_link_kind("jitter",
                   lambda seed, p: StochasticJitterLink(**{"seed": seed, **p}))


__all__ = ["LINK_KINDS", "LinkTrace", "LossyLink", "MBPS", "MarkovLink",
           "ShapedLink", "StochasticJitterLink", "TraceLink", "make_link",
           "register_link_kind", "shaped"]
