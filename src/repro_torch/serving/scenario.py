"""Scenario engine: named, seeded serving conditions + per-client
adaptation (port of ``repro.serving.scenario``).

The paper evaluates under ONE static ``tc netem`` uplink and three fixed
devices.  A :class:`Scenario` names a whole serving CONDITION — a link
shape from the adversarial family in :mod:`repro_torch.serving.netsim`
(trace-driven dropouts, Markov "Wi-Fi rate-adaptation" regimes, loss with
retransmit, stochastic jitter), a device zoo from
:mod:`repro_torch.serving.profiles`, the client population/rate, and an
adaptation-mode ladder — in one frozen, JSON-round-trippable schema with
an explicit seed, registered in ``SCENARIOS`` exactly like routers and
wire codecs.  ``Deployment.scenario_sim(name)`` and the CLI
``--scenario`` flag drive a manifest through any registered scenario.

Adaptation closes the loop per client: each decision picks one
:class:`AdaptationMode` — a (payload scale, extra encode time, fidelity)
point standing for a codec / split-point / compression choice — from the
client's OBSERVED link feedback (measured transfer bandwidth and queueing
delay of past payloads, available only once those transfers complete — no
clairvoyance).  The rule-based baseline (``"rule"``) sends the
highest-fidelity mode whose predicted decision latency fits a budget, the
paper's break-even logic generalised to time-varying links;
``register_adaptation`` is the pluggable policy hook (a learned
controller slots in without touching the sim).  ``"none"`` and
``"static:<i>"`` are the no-adaptation baselines.

The delivered-return proxy scores what an RL deployment actually earns:
each decision contributes its mode's fidelity if it arrives within the
deadline and zero otherwise, averaged over requests.  A static
full-fidelity config loses return to deadline misses under adversarial
links; a static compact config caps return at its fidelity everywhere;
the controller's job is to dominate the best static on return at no worse
p95 and no more uplink bytes.

Determinism contract: a scenario's seed fully determines its link trace,
and every sim entry point resets the link (including its RNG) before
replaying — same name + seed in, bitwise-identical latencies out.  With
``n_servers=1``, a static-link scenario under ``"none"`` reduces bitwise
to the :class:`~repro_torch.serving.server.BatchQueueSim` path.  The
link draws from numpy generators seeded as the reference seeds them, so
equal scenarios give the reference's latencies bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Union

import numpy as np

from repro_torch.schema import check_version
from repro_torch.serving import netsim, profiles
from repro_torch.serving.fleet import FleetQueueSim
from repro_torch.serving.netsim import MBPS

SCENARIO_VERSION = 1


def _freeze(x):
    """Recursively convert JSON containers to hashable tuples."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((str(k), _freeze(v)) for k, v in x.items()))
    return x


def _thaw(x):
    """Tuples back to JSON lists (the top-level (key, value) pairing is
    undone by :meth:`Scenario.params_dict`, not here)."""
    if isinstance(x, tuple):
        return [_thaw(v) for v in x]
    return x


@dataclasses.dataclass(frozen=True)  # repro: allow(schema-version) -- nested in Scenario; versioned by the parent's SCENARIO_VERSION field
class AdaptationMode:
    """One point on the codec/split-point ladder a client can pick.

    ``payload_scale`` multiplies the deployment's wire payload (codec +
    split-point choice: fp32 -> int8 is 1/4, extra spatial downsampling
    1/4 again, ship-the-frame server-only is > 1), ``encode_s`` is the
    EXTRA on-device time the mode costs before the payload hits the
    uplink (heavier compression is not free), and ``fidelity`` in [0, 1]
    is the mode's relative decision quality — the weight it earns in the
    delivered-return proxy.
    """
    name: str
    payload_scale: float = 1.0
    encode_s: float = 0.0
    fidelity: float = 1.0

    def __post_init__(self):
        if self.payload_scale <= 0.0:
            raise ValueError(f"payload_scale must be > 0: "
                             f"{self.payload_scale}")
        if self.encode_s < 0.0:
            raise ValueError(f"encode_s must be >= 0: {self.encode_s}")
        if not 0.0 <= self.fidelity <= 1.0:
            raise ValueError(f"fidelity must be in [0, 1]: {self.fidelity}")

    def to_dict(self) -> dict:
        return {"name": self.name, "payload_scale": self.payload_scale,
                "encode_s": self.encode_s, "fidelity": self.fidelity}

    @classmethod
    def from_dict(cls, d: dict) -> "AdaptationMode":
        return cls(name=d["name"],
                   payload_scale=float(d["payload_scale"]),
                   encode_s=float(d["encode_s"]),
                   fidelity=float(d["fidelity"]))


FULL_MODE = AdaptationMode("full", 1.0, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded serving condition (frozen, JSON-round-trippable).

    ``link_kind`` names a builder in ``netsim.LINK_KINDS`` and
    ``link_params`` its JSON-shaped kwargs as sorted (key, value) pairs
    (nested sequences are tuples); seeded link kinds receive ``seed``.
    ``devices`` are profile names cycled across the fleet's servers.
    ``modes`` is the adaptation ladder; mode 0 is the deployment default
    (what ``"none"`` always sends).
    """
    name: str
    link_kind: str
    link_params: tuple = ()
    seed: int = 0
    devices: tuple = ("jetson_nano",)
    modes: tuple = (FULL_MODE,)
    rate_hz: float = 10.0
    horizon_s: float = 10.0
    n_clients: int = 8
    deadline_s: float = 0.1
    adversarial: bool = False
    notes: str = ""

    def __post_init__(self):
        # canonicalise: pairs or dict in, sorted frozen (key, value) out —
        # so construction order never breaks equality or round-trips
        object.__setattr__(self, "link_params",
                           _freeze(dict(self.link_params)))
        object.__setattr__(self, "devices", tuple(self.devices))
        object.__setattr__(self, "modes", tuple(self.modes))
        if not self.name:
            raise ValueError("scenario needs a name")
        if self.link_kind not in netsim.LINK_KINDS:
            raise ValueError(f"unknown link kind {self.link_kind!r}; "
                             f"registered: {sorted(netsim.LINK_KINDS)}")
        if not isinstance(self.seed, int) or self.seed < 0:
            raise ValueError(f"seed must be a non-negative int: {self.seed}")
        if not self.modes:
            raise ValueError("scenario needs >= 1 adaptation mode")
        if len({m.name for m in self.modes}) != len(self.modes):
            raise ValueError("mode names must be unique")
        if not self.devices:
            raise ValueError("scenario needs >= 1 device profile")
        if self.rate_hz <= 0 or self.horizon_s <= 0 or self.deadline_s <= 0:
            raise ValueError("rate_hz, horizon_s, deadline_s must be > 0")
        if self.n_clients < 1:
            raise ValueError(f"n_clients must be >= 1: {self.n_clients}")

    @property
    def is_static(self) -> bool:
        """True when the link does not vary over time (the reduction
        contract: at n_servers=1 these replay ``BatchQueueSim`` bitwise
        under the ``\"none\"`` controller)."""
        return self.link_kind == "static"

    def params_dict(self) -> dict:
        return {k: _thaw(v) if isinstance(v, tuple) else v
                for k, v in self.link_params}

    def make_link(self):
        """Build this scenario's link; ``reset()`` replays it bitwise."""
        return netsim.make_link(self.link_kind, seed=self.seed,
                                **self.params_dict())

    def service_models(self, n_servers: int) -> tuple:
        return profiles.zoo(self.devices, n_servers)

    def validate(self) -> None:
        """Full validation: field checks happened at construction; this
        also builds the link and resolves every device profile."""
        self.make_link()
        for d in self.devices:
            profiles.get_profile(d)

    # ---- serialisation (mirrors DeploymentConfig's manifest contract) ----
    def to_dict(self) -> dict:
        return {
            "version": SCENARIO_VERSION,
            "name": self.name,
            "seed": self.seed,
            "link": {"kind": self.link_kind, "params": self.params_dict()},
            "devices": list(self.devices),
            "modes": [m.to_dict() for m in self.modes],
            "rate_hz": self.rate_hz,
            "horizon_s": self.horizon_s,
            "n_clients": self.n_clients,
            "deadline_s": self.deadline_s,
            "adversarial": self.adversarial,
            "notes": self.notes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        check_version("Scenario", d.pop("version", SCENARIO_VERSION),
                      (SCENARIO_VERSION,))
        link = d.pop("link")
        return cls(name=d["name"], seed=int(d.get("seed", 0)),
                   link_kind=link["kind"],
                   link_params=_freeze(link.get("params", {})),
                   devices=tuple(d.get("devices", ("jetson_nano",))),
                   modes=tuple(AdaptationMode.from_dict(m)
                               for m in d.get("modes", [])) or (FULL_MODE,),
                   rate_hz=float(d.get("rate_hz", 10.0)),
                   horizon_s=float(d.get("horizon_s", 10.0)),
                   n_clients=int(d.get("n_clients", 8)),
                   deadline_s=float(d.get("deadline_s", 0.1)),
                   adversarial=bool(d.get("adversarial", False)),
                   notes=str(d.get("notes", "")))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    # ---- the sim ---------------------------------------------------------
    def sim(self, payload_bytes: int, *, n_servers: int = 1,
            router="round_robin", max_batch: int = 8,
            max_wait_s: float = 0.0, action_bytes: int = 64,
            adaptation="none",
            service_models=None) -> "ScenarioFleetSim":
        """This scenario as a runnable :class:`ScenarioFleetSim` for a
        deployment whose default wire payload is ``payload_bytes``."""
        if service_models is None:
            service_models = self.service_models(n_servers)
        return ScenarioFleetSim(
            service_time_s=0.0, uplink=self.make_link(),
            payload_bytes=payload_bytes, action_bytes=action_bytes,
            rate_hz=self.rate_hz, horizon_s=self.horizon_s,
            max_batch=max_batch, max_wait_s=max_wait_s,
            n_servers=n_servers, router=router,
            service_models=tuple(service_models),
            modes=self.modes, adaptation=adaptation,
            deadline_s=self.deadline_s)


# ---------------------------------------------------------------------------
# Scenario registry
# ---------------------------------------------------------------------------

SCENARIOS: dict[str, Scenario] = {}


def register_scenario(s: Scenario) -> Scenario:
    s.validate()
    SCENARIOS[s.name] = s
    return s


def get_scenario(name: Union[str, Scenario]) -> Scenario:
    if isinstance(name, Scenario):
        return name
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; registered: "
                         f"{', '.join(SCENARIOS)}") from None


def scenario_names() -> tuple[str, ...]:
    return tuple(SCENARIOS)


# ---------------------------------------------------------------------------
# Adaptation controllers
# ---------------------------------------------------------------------------

class StaticController:
    """No adaptation: every client always sends ``modes[idx]``."""

    def __init__(self, modes, payload_bytes: int, deadline_s: float,
                 *, idx: int = 0):
        if not 0 <= idx < len(modes):
            raise ValueError(f"static mode index {idx} out of range "
                             f"for {len(modes)} modes")
        self.idx = idx

    def choose(self, client: int, t_obs: float) -> int:
        return self.idx

    def observe(self, client: int, mode_idx: int, t_send: float,
                trace) -> None:
        pass


class RuleController:
    """Rule-based per-client adaptation: break-even logic on observed
    link feedback.

    Each completed transfer teaches the client its current link: measured
    transfer bandwidth ``8 * bytes / (tx_done - start)`` and queueing
    delay ``start - t_send``.  Feedback becomes visible only at the
    transfer's arrival time (no clairvoyance — a payload stuck in a
    dropout teaches nothing until it lands).  The client additionally
    reads its own send queue, the signal a real sender gets for free
    from its ACK clock: a transfer still outstanding ``age`` seconds
    after it was sent bounds the current bandwidth above by
    ``8 * bytes / age``, so congestion is detected one decision after it
    starts instead of one full drain later.  Each decision then sends
    the highest-fidelity mode whose PREDICTED latency (extra encode +
    last queueing delay + payload / estimated bandwidth) fits
    ``budget_frac * deadline_s``; when no mode fits, the
    lowest-predicted-latency mode.  Before any feedback: mode 0, the
    deployment default.
    """

    def __init__(self, modes, payload_bytes: int, deadline_s: float,
                 *, budget_frac: float = 0.5):
        self.modes = tuple(modes)
        self.payload_bytes = int(payload_bytes)
        self.budget_s = float(budget_frac) * float(deadline_s)
        # client -> [(t_send, avail_at, bw, qd, payload_bytes)]
        self._pending: dict[int, list] = {}
        self._state: dict[int, tuple] = {}    # client -> (bw_bps, queue_s)

    def choose(self, client: int, t_obs: float) -> int:
        pending = self._pending.get(client, [])
        ripe = [p for p in pending if p[1] <= t_obs]
        if ripe:
            self._state[client] = ripe[-1][2:4]
            pending = [p for p in pending if p[1] > t_obs]
            self._pending[client] = pending
        bw, qd = self._state.get(client, (np.inf, 0.0))
        if pending:
            # oldest still-outstanding transfer: implied bandwidth bound
            t_send, _, _, _, payload = pending[0]
            age = t_obs - t_send
            if age > self.budget_s:
                bw = min(bw, 8.0 * payload / age)
                qd = 0.0
        best, best_pred, fallback = None, np.inf, 0
        for i, m in enumerate(self.modes):
            payload = max(1, int(round(self.payload_bytes * m.payload_scale)))
            pred = m.encode_s + qd + 8.0 * payload / bw
            if pred <= self.budget_s and (best is None or
                                          m.fidelity >
                                          self.modes[best].fidelity):
                best = i
            if pred < best_pred:
                best_pred, fallback = pred, i
        return best if best is not None else fallback

    def observe(self, client: int, mode_idx: int, t_send: float,
                trace) -> None:
        tx = trace.tx_done - trace.start
        bw = 8.0 * trace.payload_bytes / tx if tx > 0.0 else np.inf
        qd = max(0.0, trace.start - t_send)
        self._pending.setdefault(client, []).append(
            (t_send, trace.arrival, bw, qd, trace.payload_bytes))


# factory(modes, payload_bytes, deadline_s) -> controller
ADAPTATIONS: dict[str, Callable] = {}


def register_adaptation(name: str, factory: Callable) -> Callable:
    """Pluggable policy hook: register a controller factory with
    signature ``factory(modes, payload_bytes, deadline_s) -> controller``
    where a controller has ``choose(client, t_obs) -> mode_idx`` and
    ``observe(client, mode_idx, t_send, link_trace)``."""
    ADAPTATIONS[name] = factory
    return factory


def get_adaptation(name: Union[str, Callable]) -> Callable:
    if callable(name):
        return name
    if isinstance(name, str) and name.startswith("static:"):
        idx = int(name.split(":", 1)[1])
        return lambda modes, pb, dl: StaticController(modes, pb, dl, idx=idx)
    try:
        return ADAPTATIONS[name]
    except KeyError:
        raise ValueError(f"unknown adaptation {name!r}; registered: "
                         f"{', '.join(ADAPTATIONS)} (or static:<i>)") \
            from None


def adaptation_names() -> tuple[str, ...]:
    return tuple(ADAPTATIONS)


register_adaptation("none", StaticController)
register_adaptation("rule", RuleController)


# ---------------------------------------------------------------------------
# The scenario simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioReport:
    """Per-run scorecard: latency tail, uplink byte bill, and the
    delivered-return proxy (mean over requests of mode fidelity for
    in-deadline decisions, zero for late ones)."""
    latencies: np.ndarray
    mode_idx: np.ndarray
    total_uplink_bytes: int
    delivered_return: float
    deadline_s: float
    mode_names: tuple

    @property
    def n_requests(self) -> int:
        return int(self.latencies.size)

    @property
    def p95_s(self) -> float:
        return float(np.percentile(self.latencies, 95))

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.latencies))

    @property
    def deadline_hit_rate(self) -> float:
        return float(np.mean(self.latencies <= self.deadline_s))

    def mode_counts(self) -> dict:
        return {name: int(np.sum(self.mode_idx == i))
                for i, name in enumerate(self.mode_names)}


@dataclasses.dataclass
class ScenarioFleetSim(FleetQueueSim):
    """:class:`FleetQueueSim` under a scenario: per-request adaptation.

    Before each request crosses the uplink, the controller picks one
    :class:`AdaptationMode` for that client — scaling the payload and
    charging the mode's extra encode time — and is fed the resulting
    link trace as delayed feedback.  Everything downstream (routing,
    per-server micro-batching, serialised downlinks) is the unmodified
    fleet engine.  With the default single full mode and the ``"none"``
    controller this IS ``FleetQueueSim`` (and at n_servers=1,
    ``BatchQueueSim``) bitwise.

    Arrivals are re-sorted (stably) into arrival order before the event
    engine runs: a no-op for monotone links, and it upholds the engine's
    time-order assumption when jittery links reorder arrivals.
    """

    modes: tuple = (FULL_MODE,)
    adaptation: Union[str, Callable] = "none"
    deadline_s: float = 0.1

    def _request_arrivals(self, n_clients: int):
        self.uplink.reset()
        factory = get_adaptation(self.adaptation)
        ctrl = factory(self.modes, self.payload_bytes, self.deadline_s)
        period = 1.0 / self.rate_hz
        events = []
        for c in range(n_clients):
            t = c * period / n_clients       # staggered clients
            while t < self.horizon_s:
                events.append((t, c))
                t += period
        events.sort()
        arr, mode_idx, nbytes = [], [], []
        for t_obs, c in events:
            m = ctrl.choose(c, t_obs)
            if not 0 <= m < len(self.modes):
                raise ValueError(f"controller chose mode {m} of "
                                 f"{len(self.modes)}")
            mode = self.modes[m]
            payload = max(1, int(round(self.payload_bytes
                                       * mode.payload_scale)))
            tr = self.uplink.send(t_obs + mode.encode_s, payload)
            ctrl.observe(c, m, t_obs + mode.encode_s, tr)
            arr.append((t_obs, tr.arrival, c))
            mode_idx.append(m)
            nbytes.append(payload)
        order = np.argsort(np.asarray([a for _, a, _ in arr]), kind="stable")
        self._last_mode_idx = np.asarray(mode_idx, np.int64)[order]
        self._last_bytes = np.asarray(nbytes, np.int64)[order]
        return [arr[i] for i in order]

    def report(self, n_clients: int) -> ScenarioReport:
        """Run the scenario and score it (latencies in request order,
        aligned with the modes that produced them)."""
        tr = self._simulate(n_clients)
        lat = tr["recv"] - tr["t_obs"]
        fid = np.asarray([m.fidelity for m in self.modes])[
            self._last_mode_idx]
        delivered = float(np.mean(np.where(lat <= self.deadline_s,
                                           fid, 0.0)))
        return ScenarioReport(
            latencies=lat, mode_idx=self._last_mode_idx.copy(),
            total_uplink_bytes=int(self._last_bytes.sum()),
            delivered_return=delivered, deadline_s=self.deadline_s,
            mode_names=tuple(m.name for m in self.modes))


# ---------------------------------------------------------------------------
# Built-in scenarios
# ---------------------------------------------------------------------------

# The adaptation ladder used by the adversarial built-ins: mode 0 is the
# deployment default (full payload, nothing extra to pay), "compact" is a
# heavier on-device compression (int8 + spatial downsample: 1/8 the
# bytes) costing 30 ms extra encode and a fidelity haircut.
DEFAULT_MODES = (AdaptationMode("full", 1.0, 0.0, 1.0),
                 AdaptationMode("compact", 0.125, 0.030, 0.7))

register_scenario(Scenario(
    name="static_100mbps", link_kind="static",
    link_params=(("bandwidth_bps", 100 * MBPS), ("propagation_s", 0.002)),
    devices=("jetson_nano",),
    notes="Table 6 reference uplink: one static 100 Mb/s shaped link"))

register_scenario(Scenario(
    name="static_10mbps", link_kind="static",
    link_params=(("bandwidth_bps", 10 * MBPS), ("propagation_s", 0.002)),
    devices=("jetson_nano",),
    notes="below the paper's ~50 Mb/s break-even: uplink-bound serving"))

register_scenario(Scenario(
    name="zoo_static", link_kind="static",
    link_params=(("bandwidth_bps", 100 * MBPS), ("propagation_s", 0.002)),
    devices=("jetson_nano", "pi_4b", "pi_zero_2w"),
    notes="heterogeneous fleet on the reference uplink: routing policy "
          "decides how much the slow shards hurt"))

register_scenario(Scenario(
    name="jittery_wifi", link_kind="jitter",
    link_params=(("bandwidth_bps", 40 * MBPS), ("propagation_s", 0.004),
                 ("jitter_s", 0.004)),
    devices=("jetson_nano",), seed=7,
    notes="seeded netem-style delay variation on a 40 Mb/s uplink"))

register_scenario(Scenario(
    name="lossy_uplink", link_kind="lossy",
    link_params=(("bandwidth_bps", 40 * MBPS), ("loss_p", 0.05),
                 ("rto_s", 0.03), ("propagation_s", 0.004)),
    devices=("jetson_nano",), seed=11, adversarial=True,
    modes=DEFAULT_MODES,
    notes="5% Bernoulli loss, 30 ms RTO retransmits, head-of-line "
          "blocking"))

register_scenario(Scenario(
    name="trace_dropout", link_kind="trace",
    link_params=(("schedule", ((0.0, 100 * MBPS), (3.0, 4 * MBPS),
                               (4.0, 100 * MBPS), (7.0, 4 * MBPS),
                               (8.0, 100 * MBPS))),
                 ("propagation_s", 0.002)),
    devices=("jetson_nano",), horizon_s=12.0, adversarial=True,
    modes=DEFAULT_MODES,
    notes="trace-driven adversary: two 1 s dropouts to 4 Mb/s carve "
          "~17% of the horizon out of a 100 Mb/s uplink — the designed "
          "adaptation gate (deterministic)"))

register_scenario(Scenario(
    name="wifi_markov", link_kind="markov",
    link_params=(("states_bps", (100 * MBPS, 20 * MBPS, 2 * MBPS)),
                 ("transition", ((0.90, 0.08, 0.02),
                                 (0.30, 0.55, 0.15),
                                 (0.10, 0.30, 0.60))),
                 ("dwell_s", 0.25), ("propagation_s", 0.004)),
    devices=("jetson_nano",), seed=13, horizon_s=12.0, adversarial=True,
    modes=DEFAULT_MODES,
    notes="Wi-Fi rate-adaptation regimes: seeded Markov hops between "
          "100/20/2 Mb/s every 250 ms"))


__all__ = ["AdaptationMode", "FULL_MODE", "DEFAULT_MODES", "Scenario",
           "SCENARIOS", "SCENARIO_VERSION", "register_scenario",
           "get_scenario", "scenario_names", "StaticController",
           "RuleController", "ADAPTATIONS", "register_adaptation",
           "get_adaptation", "adaptation_names", "ScenarioReport",
           "ScenarioFleetSim"]
