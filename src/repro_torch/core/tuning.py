"""Per-manifest kernel autotuning: measure the live kernels, freeze the
winner (port of ``repro.core.tuning``).

1. :func:`default_candidates` spans the reference's search grid —
   execution backend (every registered one) x ``tile_h`` x micro-batch
   size — for the manifest's serving shape.
2. :func:`prune_candidates` cuts the grid with a cost model re-derived from
   the port's own measurements on an H100 (launch overhead of a kernel
   wrapper, the fused kernels' time per modelled tile cycle, the layer
   kernels' FLOP rate), so only plausible candidates are measured.
3. :func:`tune` measures the survivors through the real pipeline
   (``Deployment.build`` + ``encoder.apply``) on the deployment's device
   and returns the winning :class:`TunedPlan`, stamped with the execution
   mode (``cuda`` on the card, ``eager`` on the CPU) and the host.

``Deployment.build`` honours a frozen block only when its ``mode`` is one
of the port's (:data:`PORT_MODES`): a block the reference measured on its
own hardware says nothing about this one.  The timer and the measurement
function are injectable, which makes the tuner deterministic under test
stubs.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Callable, Iterable, Optional, Sequence

import torch

from repro_torch.core.backends import backend_names, get_backend
from repro_torch.core.passplan import SMEM_LIMIT, tile_cost
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.schema import check_version
from repro_torch.serving.server import _block

TUNING_VERSION = 1

# Execution modes the port stamps (``repro_torch.perfstamp``); the
# reference stamps "interpret" / "compiled".
PORT_MODES = ("eager", "cuda")

# Per-unit costs of the pruning model, from the port's measurements
# (PERF.md section 6, chip_smoke, NVIDIA H100 80GB HBM3 at 700 W).  Only
# ratios matter: pruning compares candidates with each other.
# Host time of one kernel wrapper call (ctypes launch): K2's 9 launches
# took 0.2300 ms at B=1.
_LAUNCH_OVERHEAD_S = 25e-6
# Seconds per cycle of the fused kernels' tile model
# (``passplan.tile_cost``): K4 on 64 frames of 400x400x4 with the
# 512-wide head took 1.3974-1.3990 ms of device time for 504,242 modelled
# cycles (NVIDIA H100 80GB HBM3, 700 W).
# (K1 on one 84x84 frame takes 1.5e-9 a cycle: the model leaves out a
# launch's fixed costs, which the launch overhead below carries.)
_TILE_CYCLE_S = 2.8e-9
# fp32 FLOP/s of the layer kernels (K2, K3) over the whole card: K3's three
# launches on 2 frames of 400x400x4 (262 MFLOP) took 0.1023 ms.
_LAYER_FLOP_RATE = 2.56e12
# Device memory rate of an H100 SXM (NVIDIA data sheet, HBM3).
_BYTES_RATE = 3.35e12
# Host-side calls of one layer on the eager path: pad, conv, activation.
_EAGER_OPS_PER_LAYER = 3


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search grid: HOW to execute the serving batch."""

    backend: str             # execution-backend name (registry)
    tile_h: int              # the reference's output-row tile height
    micro_batch: int         # frames per launch (splits max_batch)


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The measured winner, frozen into the deployment manifest.

    ``time_s`` is the median launch time at ``micro_batch`` frames;
    ``per_frame_s`` the serving cost per frame at the manifest's
    ``max_batch``.  ``mode``/``host`` record WHERE the measurement holds.
    All fields are scalars, keeping the config hashable.
    """

    backend: str
    tile_h: int
    micro_batch: int
    time_s: float = 0.0
    per_frame_s: float = 0.0
    mode: str = "interpret"
    host: str = ""
    searched: int = 0        # candidates actually measured
    pruned: int = 0          # candidates cut by the cost model
    version: int = TUNING_VERSION

    @property
    def measured_by_port(self) -> bool:
        return self.mode in PORT_MODES

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedPlan":
        d = dict(d)
        version = check_version("TunedPlan tuning block",
                                d.pop("version", TUNING_VERSION),
                                (TUNING_VERSION,))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown TunedPlan fields: {sorted(unknown)}")
        return cls(version=version, **d)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

def _plan_and_head(config):
    plan = config.spec.plan(config.in_h, config.in_w)
    head = plan.head(config.head_dim, activation=config.head_act)
    return plan, head


def estimated_cost_s(config, cand: Candidate) -> float:
    """Modelled per-frame serving cost of ``cand`` at ``config.max_batch``.

    A launch group costs the host time of its kernel calls, plus the
    device time of its frames, plus their bytes at the memory rate.  The
    fused tiers run the tile plan of the launch (K4's, with its resident
    blocks, when a streamed backend streams) at the measured time per
    modelled cycle.  The per-pass, grouped and eager tiers spread every
    frame's pixels over the card at the layer kernels' rate.
    """
    backend = get_backend(cand.backend)
    plan, head_plan = _plan_and_head(config)
    micro = max(1, min(cand.micro_batch, config.max_batch))
    n_launch_groups = math.ceil(config.max_batch / micro)

    first = plan.layers[0]
    in_bytes = first.in_h * first.in_w * first.c_in * 4
    out_bytes = plan.feature_bytes * 4 + head_plan.out_dim * 4
    bytes_s = micro * (in_bytes + out_bytes) / _BYTES_RATE
    if backend.mode == "fused":
        launches = 1
        streamed = backend.streamed and micro > plan.max_safe_batch()
        tp = plan.tile_plan(micro, streamed=streamed)
        device_s = tile_cost(tp, micro) * _TILE_CYCLE_S
    else:
        launches = {"xla": _EAGER_OPS_PER_LAYER * len(plan.layers),
                    "per_pass": plan.total_passes,
                    "grouped": len(plan.layers)}[backend.mode]
        device_s = (micro * (plan.flops_per_frame + head_plan.flops)
                    / _LAYER_FLOP_RATE)
    t_launch = launches * _LAUNCH_OVERHEAD_S + device_s + bytes_s
    return n_launch_groups * t_launch / config.max_batch


def launch_feasible(config, cand: Candidate) -> bool:
    """Can ``cand`` launch at all?  The counterpart of the reference's
    ``vmem_feasible``.  The card has no VMEM budget: K1 and K4 take any
    batch, one halo tile at a time, and read a layer's weights from
    device memory when no tile fits them in shared memory; they refuse
    only a spec of which not even a 1x1 tile fits.  K2 stages at most 4 KB
    of taps.  K3 stages a whole layer's weights in shared memory:
    ``grouped`` is feasible when every layer's fit."""
    mode = get_backend(cand.backend).mode
    plan, _ = _plan_and_head(config)
    if mode == "fused":
        try:
            plan.tile_plan(1, streamed=True)
        except ValueError:
            return False
        return True
    if mode != "grouped":
        return True
    return all(4 * l.kernel * l.kernel * l.c_in * l.c_out_pad <= SMEM_LIMIT
               for l in plan.layers)


# ---------------------------------------------------------------------------
# Search space
# ---------------------------------------------------------------------------

def default_candidates(config, *,
                       backends: Optional[Sequence[str]] = None,
                       tile_hs: Optional[Sequence[int]] = None,
                       micro_batches: Optional[Sequence[int]] = None
                       ) -> tuple[Candidate, ...]:
    """The registry-driven search grid for one manifest, built as the
    reference builds it.

    Backends default to every registered execution backend; ``tile_h``
    spans powers of two up to the feature height; micro-batches span
    powers of two up to ``max_batch`` plus ``max_batch`` itself and the
    plan's ``max_safe_batch``.  The grid is canonically ordered (sorted,
    deduplicated), which is what makes the tuner deterministic.
    """
    plan, _ = _plan_and_head(config)
    if backends is None:
        backends = backend_names()
    if tile_hs is None:
        tile_hs = sorted({t for t in (4, 8, 16, plan.out_h)
                          if 1 <= t <= plan.out_h}) or [plan.out_h]
    if micro_batches is None:
        mbs = {1 << i for i in range(config.max_batch.bit_length())
               if 1 << i <= config.max_batch}
        mbs.add(config.max_batch)
        max_safe = plan.max_safe_batch()
        if 1 <= max_safe <= config.max_batch:
            mbs.add(max_safe)
        micro_batches = sorted(mbs)
    out = []
    for b in backends:
        name = get_backend(b).name
        for t in sorted(set(tile_hs)):
            for m in sorted(set(micro_batches)):
                out.append(Candidate(backend=name, tile_h=t, micro_batch=m))
    # non-fused tiers ignore tile_h — collapse their duplicates
    seen, uniq = set(), []
    for c in out:
        key = (c.backend, c.tile_h if get_backend(c.backend).mode == "fused"
               else 0, c.micro_batch)
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    return tuple(uniq)


def baseline_candidate(config) -> Candidate:
    """The manifest's current (untuned) execution point, with ``tile_h``
    clamped to the feature height (the grid's canonical form)."""
    plan, _ = _plan_and_head(config)
    return Candidate(backend=get_backend(config.backend).name,
                     tile_h=max(1, min(config.tile_h, plan.out_h)),
                     micro_batch=config.max_batch)


def prune_candidates(config, candidates: Iterable[Candidate], *,
                     keep_ratio: float = 3.0
                     ) -> tuple[tuple[Candidate, ...], int]:
    """(survivors, n_pruned) after launch-feasibility + cost-ratio cuts.

    A candidate survives when it can launch (:func:`launch_feasible`) and
    its modelled cost is within ``keep_ratio`` of the cheapest feasible
    candidate.  The manifest's own baseline point always survives, so
    tuning never regresses below "measure what you already had".  So does
    the cheapest point of every backend: the model holds a few measured
    rates and may choose which point of a backend to measure but not rule
    a backend out unmeasured.
    """
    cands = list(candidates)
    base = baseline_candidate(config)
    feasible = [c for c in cands if launch_feasible(config, c)]
    if not feasible:
        raise ValueError("no launchable tuning candidate: the grouped "
                         "kernel's layer weights exceed shared memory and "
                         "no other backend was given")
    costs = {c: estimated_cost_s(config, c) for c in feasible}
    best = min(costs.values())
    cheapest = {}
    for c in feasible:
        if c.backend not in cheapest or costs[c] < costs[cheapest[c.backend]]:
            cheapest[c.backend] = c
    kept = [c for c in feasible if costs[c] <= keep_ratio * best
            or c == cheapest[c.backend]]
    if base not in kept and launch_feasible(config, base):
        kept.append(base)
    return tuple(kept), max(0, len(cands) - len(kept))


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def measure_candidate(config, cand: Candidate, *, iters: int = 5,
                      timer: Callable[[], float] = time.perf_counter,
                      seed: int = 0, device: DeviceLike = None) -> float:
    """Median wall-clock seconds of ONE encoder call at
    ``cand.micro_batch`` frames, through the real pipeline
    (``Deployment.build`` -> ``encoder.apply``) on ``device``.

    One warm-up call comes first, outside the timed window: it builds the
    CUDA kernels at their first use (nvcc) and warms the caches.  Each
    window ends with a device synchronize (``_block``): CUDA launches
    return before the kernel ends.
    """
    from repro_torch.deploy import Deployment  # lazy: deploy imports this
    cfg = dataclasses.replace(config, backend=cand.backend,
                              tile_h=cand.tile_h, tuning=None,
                              max_batch=max(config.max_batch,
                                            cand.micro_batch))
    dep = Deployment.build(cfg, device=device)
    params = dep.init(torch.Generator().manual_seed(seed))
    x = torch.rand((cand.micro_batch, config.in_h, config.in_w,
                    config.spec.layers[0].c_in),
                   generator=torch.Generator().manual_seed(seed + 1))
    x = x.to(dep.device)
    apply = dep.encoder.apply
    samples = []
    with torch.inference_mode():
        _block(apply(params, x))
        for _ in range(iters):
            t0 = timer()
            _block(apply(params, x))
            samples.append(timer() - t0)
    return statistics.median(samples)


def _serving_cost(config, cand: Candidate, t_launch: float) -> float:
    """Per-frame cost of serving ``max_batch`` frames in
    ``micro_batch``-sized launches, each costing ``t_launch``."""
    micro = max(1, min(cand.micro_batch, config.max_batch))
    return math.ceil(config.max_batch / micro) * t_launch / config.max_batch


def tune(config, *, candidates: Optional[Sequence[Candidate]] = None,
         iters: int = 5, keep_ratio: float = 3.0,
         timer: Callable[[], float] = time.perf_counter,
         measure: Optional[Callable] = None,
         log: Optional[Callable[[str], None]] = None,
         device: DeviceLike = None) -> TunedPlan:
    """Autotune one manifest on ``device`` (``"cuda"`` by default): prune
    the grid, measure the survivors, freeze the winner.

    ``measure(config, cand)`` -> launch seconds is injectable (tests use
    the cost model itself, or a stub timer); the default measures the
    live kernels via :func:`measure_candidate`.  Scoring is per-frame
    serving cost at ``config.max_batch``; ties break toward the canonical
    candidate order, so identical measurements always pick the same
    winner.
    """
    from repro_torch.perfstamp import execution_mode, host_fingerprint
    dev = resolve_device(device)
    if candidates is None:
        candidates = default_candidates(config)
    kept, n_pruned = prune_candidates(config, candidates,
                                      keep_ratio=keep_ratio)
    if measure is None:
        def measure(cfg, cand):
            return measure_candidate(cfg, cand, iters=iters, timer=timer,
                                     device=dev)
    best_c, best_t, best_cost = None, None, float("inf")
    for cand in kept:
        t_launch = measure(config, cand)
        cost = _serving_cost(config, cand, t_launch)
        if log is not None:
            log(f"  {cand.backend:>12} tile_h={cand.tile_h:<3} "
                f"micro={cand.micro_batch:<3} t={t_launch * 1e3:8.3f} ms "
                f"-> {cost * 1e6:9.1f} us/frame")
        if cost < best_cost:
            best_c, best_t, best_cost = cand, t_launch, cost
    assert best_c is not None
    return TunedPlan(backend=best_c.backend, tile_h=best_c.tile_h,
                     micro_batch=best_c.micro_batch, time_s=best_t,
                     per_frame_s=best_cost, mode=execution_mode(dev),
                     host=host_fingerprint(), searched=len(kept),
                     pruned=n_pruned)


def suggest_tuning(config) -> Candidate:
    """Cheapest cost-model candidate WITHOUT measuring: a starting point
    when a full tune is too expensive."""
    kept, _ = prune_candidates(config, default_candidates(config))
    return min(kept, key=lambda c: estimated_cost_s(config, c))


__all__ = ["Candidate", "PORT_MODES", "TUNING_VERSION", "TunedPlan",
           "baseline_candidate", "default_candidates", "estimated_cost_s",
           "launch_feasible", "measure_candidate", "prune_candidates",
           "suggest_tuning", "tune"]
