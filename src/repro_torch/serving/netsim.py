"""Deterministic bandwidth-shaped link simulation (port of the static link
of ``repro.serving.netsim``).

A serialising link with finite bandwidth, fixed propagation delay and
(optional) deterministic jitter: transfers are serialised FIFO, so a
transfer cannot start before the previous one finished.  Jitter is extra
propagation delay on one transfer's arrival and never occupies the link;
the per-transfer pattern cycles 0.5x / 1.0x / 1.5x of ``jitter_s``.  Pure
float arithmetic, so it gives the reference's numbers exactly.  The
adversarial links come with the fleet (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import dataclasses


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
        """Enqueue a transfer at time ``t``; returns its timing trace."""
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


__all__ = ["LinkTrace", "MBPS", "ShapedLink", "shaped"]
