"""Fleet-scale serving simulation: ``n_servers`` sharded micro-batching
(port of ``repro.serving.fleet``).

The paper's Table 6 saturates ONE server at ~10^2 clients; the road to
"heavy traffic from millions of users" is horizontal: ``n_servers``
independent micro-batching servers behind one routing layer.
:class:`FleetQueueSim` extends
:class:`~repro_torch.serving.server.BatchQueueSim` into that fleet:

* every client's observation still crosses the SHARED shaped uplink (the
  bandwidth-shaped ingress in front of the fleet — uploads serialise
  FIFO exactly as in the single-server sims);
* on arrival each request is routed to one of ``n_servers`` servers by a
  pluggable policy (``ROUTERS`` registry): ``round_robin`` (stateless
  spreading), ``least_loaded`` (fewest outstanding requests, then
  earliest-free), or ``client_affinity`` (deterministic hash of the
  client id, so one client's requests always hit the same server and
  their actions return in order);
* each server runs the SAME micro-batching policy as ``BatchQueueSim``
  (greedy launch up to ``max_batch``, optional ``max_wait_s`` hold),
  charges its OWN measured t(B) service curve, and returns its batch's
  actions over its OWN serialised downlink.

With ``n_servers=1`` every router degenerates to "server 0" and the
event-driven engine reproduces ``BatchQueueSim.latencies`` bitwise
(asserted in tests/test_torch_fleet.py, against the reference too), so
the fleet numbers are anchored to the single-server Table 6
reproduction.  Host-side float and numpy arithmetic throughout: equal
inputs give the reference's traces bit for bit.

Fleet sizing (the capacity-planning questions Table 6 cannot answer):

* :meth:`FleetQueueSim.max_clients` — supported clients at a fixed fleet
  size (geometric + binary search over the monotone p95 curve, so fleet
  sweeps stay tractable at thousands of clients);
* :meth:`FleetQueueSim.min_servers` — smallest fleet meeting a p95
  budget for a target client population.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.server import BatchQueueSim

# ---------------------------------------------------------------------------
# Routing policies
# ---------------------------------------------------------------------------
# A router maps one request to a server index.  Signature:
#     router(client, seq, t_arrival, queue_lens, free) -> int
# ``client`` is the client id, ``seq`` the global arrival sequence number,
# ``t_arrival`` the request's post-uplink arrival time, ``queue_lens[s]``
# the number of requests queued (not yet launched) at server s, and
# ``free[s]`` the time server s finishes its current batch.  Routers must
# be deterministic: the simulators are regression-pinned.

Router = Callable[[int, int, float, Sequence[int], Sequence[float]], int]

ROUTERS: dict[str, Router] = {}


def register_router(name: str, fn: Router) -> Router:
    """Register a routing policy (also usable as a plug-in point)."""
    ROUTERS[name] = fn
    return fn


def router_names() -> tuple[str, ...]:
    return tuple(ROUTERS)


def get_router(router: Union[str, Router]) -> Router:
    if callable(router):
        return router
    try:
        return ROUTERS[router]
    except KeyError:
        raise ValueError(f"unknown router {router!r}; registered: "
                         f"{', '.join(ROUTERS)}") from None


def _mix32(c: int) -> int:
    """Deterministic 32-bit integer mix (xor-shift-multiply finaliser).

    Python's ``hash`` is salted per process for str and identity for
    small ints (which would make power-of-two fleets route ``c % n`` —
    fine for balance, useless as a hash); this mix is stable across
    runs and platforms, so affinity pinning survives restarts exactly
    like a consistent-hash LB tier.
    """
    c &= 0xffffffff
    c = ((c ^ (c >> 16)) * 0x45d9f3b) & 0xffffffff
    c = ((c ^ (c >> 16)) * 0x45d9f3b) & 0xffffffff
    return (c ^ (c >> 16)) & 0xffffffff


def _round_robin(client, seq, t, queue_lens, free):
    return seq % len(free)


def _client_affinity(client, seq, t, queue_lens, free):
    return _mix32(client) % len(free)


def _least_loaded(client, seq, t, queue_lens, free):
    # outstanding work = queued requests + the in-flight batch (1 if the
    # server is still busy at arrival time); earliest-free then lowest
    # index break ties deterministically
    return min(range(len(free)),
               key=lambda s: (queue_lens[s] + (1 if free[s] > t else 0),
                              max(free[s] - t, 0.0), s))


register_router("round_robin", _round_robin)
register_router("client_affinity", _client_affinity)
register_router("least_loaded", _least_loaded)


# ---------------------------------------------------------------------------
# The fleet simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetQueueSim(BatchQueueSim):
    """``n_servers`` sharded :class:`BatchQueueSim` behind one router.

    ``service_model`` (shared) or ``service_models`` (one t(B) curve per
    server, for heterogeneous fleets) give each server its service-time
    curve; each server also owns a serialised downlink with the uplink's
    symmetric parameters.  The uplink itself — the shaped ingress — stays
    shared across the whole fleet.
    """

    n_servers: int = 1
    router: Union[str, Router] = "round_robin"
    service_models: Optional[Sequence[Callable[[int], float]]] = None

    def _server_service(self, s: int) -> Callable[[int], float]:
        if self.service_models is not None:
            if len(self.service_models) != self.n_servers:
                raise ValueError(
                    f"{len(self.service_models)} service models for "
                    f"{self.n_servers} servers")
            return self.service_models[s]
        return self.service

    # ---- the event-driven engine ------------------------------------------
    engine: str = "heap"          # "heap" (next-event queue) | "scan" (ref)

    def _simulate(self, n_clients: int) -> np.ndarray:
        """Structured per-request trace, in observation order.

        Columns: client, server, t_obs, arrival, recv.  Events are
        processed in time order — request arrivals (routed immediately)
        interleaved with per-server batch launches — with arrivals at
        time t handled before launches at time t, matching the inclusive
        ``arrival <= launch`` batch-fill rule of ``BatchQueueSim``.

        Two engines compute the identical trace: ``heap`` (default) keeps
        the pending per-server launches in a lazily-revalidated
        ``heapq`` next-event queue — O(log S) per event — while ``scan``
        (the reference) recomputes every server's launch time per event,
        O(S); the O(events x S) scan dominates wall time past ~32
        servers.  Bitwise equality of the two engines is asserted in
        tests/test_torch_fleet.py.
        """
        if self.n_servers < 1:
            raise ValueError(f"n_servers must be >= 1: {self.n_servers}")
        if self.engine not in ("heap", "scan"):
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"one of: heap, scan")
        route = get_router(self.router)
        arr = self._request_arrivals(n_clients)
        n, S = len(arr), self.n_servers
        service = [self._server_service(s) for s in range(S)]
        free = [0.0] * S
        down_free = [0.0] * S
        queues: list[deque] = [deque() for _ in range(S)]
        n_queued = [0] * S
        trace = np.zeros(n, dtype=[("client", np.int64),
                                   ("server", np.int64),
                                   ("t_obs", np.float64),
                                   ("arrival", np.float64),
                                   ("recv", np.float64)])
        ptr = 0                      # next unrouted request (arrival order)

        def launch_time(s: int) -> float:
            """Earliest launch at server s given what has been routed.

            Mirrors BatchQueueSim: greedy launches as soon as the server
            is free and work exists; with a hold, launch when the batch
            fills or the deadline expires, whichever is first.  A later
            arrival can only move the launch EARLIER (by filling the
            batch), and arrivals are processed first, so scheduling off
            currently-routed requests is exact.
            """
            q = queues[s]
            ready = max(free[s], q[0][1])
            if self.max_wait_s <= 0.0:
                return ready
            if len(q) >= self.max_batch:
                return max(ready, min(q[self.max_batch - 1][1],
                                      ready + self.max_wait_s))
            return ready + self.max_wait_s

        # ---- next-launch selection: heap vs scan --------------------------
        # Heap entries are (launch_time, server).  launch_time(s) only
        # changes when a request is routed to s or s launches a batch,
        # and BOTH events push a fresh entry — so the current value is
        # always present and any entry that disagrees with launch_time(s)
        # is stale and simply dropped on peek (classic lazy deletion;
        # re-pushing a correction here instead would duplicate the
        # current entry per stale and grow the heap quadratically on
        # saturated servers).  Ties break on the lower server index in
        # both engines ((t, s) tuple order == the scan's strict-<
        # first-s-wins).
        heap: list[tuple[float, int]] = []

        def heap_push(s: int) -> None:
            if queues[s]:
                heapq.heappush(heap, (launch_time(s), s))

        def next_launch_heap():
            while heap:
                t, s = heap[0]
                if not queues[s] or launch_time(s) != t:
                    heapq.heappop(heap)           # stale: drop, the push
                    continue                      # at the last schedule
                return s, t                       # change supersedes it
            return -1, np.inf

        def next_launch_scan():
            best_s, best_launch = -1, np.inf
            for s in range(S):
                if not queues[s]:
                    continue
                launch = launch_time(s)
                if launch < best_launch:
                    best_s, best_launch = s, launch
            return best_s, best_launch

        use_heap = self.engine == "heap"
        next_launch = next_launch_heap if use_heap else next_launch_scan

        while ptr < n or any(n_queued):
            best_s, best_launch = next_launch()
            if ptr < n and arr[ptr][1] <= best_launch:
                t_obs, arrival, client = arr[ptr]
                s = route(client, ptr, arrival, n_queued, free)
                if not 0 <= s < S:
                    raise ValueError(f"router sent request to server {s} "
                                     f"of {S}")
                queues[s].append((t_obs, arrival, ptr))
                n_queued[s] += 1
                ptr += 1
                if use_heap:
                    heap_push(s)
                continue
            q = queues[best_s]
            batch = []
            while q and len(batch) < self.max_batch \
                    and q[0][1] <= best_launch:
                batch.append(q.popleft())
            n_queued[best_s] -= len(batch)
            done = best_launch + service[best_s](len(batch))
            recv, down_free[best_s] = self._drain_downlink(
                done, len(batch), down_free[best_s])
            for (t_obs, arrival, idx), r in zip(batch, recv):
                trace[idx] = (arr[idx][2], best_s, t_obs, arrival, r)
            free[best_s] = done
            if use_heap:
                heapq.heappop(heap)               # consume the launch event
                heap_push(best_s)                 # leftover queue reschedules
        return trace

    def trace(self, n_clients: int) -> np.ndarray:
        """Per-request (client, server, t_obs, arrival, recv) record
        array in observation order — the raw material for ordering and
        balance assertions."""
        return self._simulate(n_clients)

    def latencies(self, n_clients: int) -> np.ndarray:
        t = self._simulate(n_clients)
        return t["recv"] - t["t_obs"]

    # ---- fleet sizing ------------------------------------------------------
    def max_clients(self, *, p95_budget_s: float = 0.1,
                    n_max: int = 4096) -> int:
        """Largest client population with p95 within budget.

        A geometric sweep followed by binary search replaces the
        single-server linear scan — a fleet supporting thousands of
        clients would otherwise cost thousands of simulations.  The
        sweep runs the FULL doubling ladder rather than stopping at the
        first failure: p95 DIPS after small N when a batch hold makes a
        lone client wait out ``max_wait_s``, or when affinity routing on
        a heterogeneous fleet hashes the only clients onto a slow shard,
        so a small-N failure does not imply saturation.  Beyond the dip
        p95 is monotone (shared uplink + FIFO queues) and the bisection
        between the largest pass and the next failure is exact.
        """
        budget = p95_budget_s
        probes, n = [], 1
        while True:
            probes.append((n, self.p95(n) <= budget))
            if n >= n_max:
                break
            n = min(2 * n, n_max)
        passing = [n for n, ok in probes if ok]
        if not passing:
            return 0
        lo = max(passing)
        fails_above = [n for n, ok in probes if not ok and n > lo]
        if not fails_above:
            return lo                 # passed at the n_max cap
        hi = min(fails_above)
        while hi - lo > 1:            # invariant: lo passes, hi fails
            mid = (lo + hi) // 2
            if self.p95(mid) <= budget:
                lo = mid
            else:
                hi = mid
        return lo

    def min_servers(self, n_clients: int, *, p95_budget_s: float = 0.1,
                    n_servers_max: int = 64) -> int:
        """Smallest fleet serving ``n_clients`` within the p95 budget
        (0 when even ``n_servers_max`` cannot).  The capacity-planning
        inverse of :meth:`max_clients`."""
        for s in range(1, n_servers_max + 1):
            if self.with_servers(s).p95(n_clients) <= p95_budget_s:
                return s
        return 0

    def with_servers(self, n_servers: int,
                     router: Union[str, Router, None] = None) \
            -> "FleetQueueSim":
        """This fleet at a different size (service curves shared)."""
        return dataclasses.replace(
            self, n_servers=n_servers,
            router=self.router if router is None else router,
            service_models=None if self.service_models is None
            else tuple(self.service_models[s % len(self.service_models)]
                       for s in range(n_servers)))


__all__ = ["FleetQueueSim", "ROUTERS", "Router", "get_router",
           "register_router", "router_names"]
