"""``closed_ticks``' closed loop of decision ticks, whose traced stretch
also reads the program's own spans.

``warm`` and ``run`` are ``closed_ticks``'.  ``profile`` runs
``closed_ticks``' profiled ticks with the program's tracing on
(``repro_torch.tracing``), so that the program's spans land in the trace
beside the harness's, and reduces the trace over both at any depth
(``bench.spans.reduce_nested``).  The device ms a tick under each span
(``device_ms``), the idle ms a tick while the host was inside it
(``idle_ms``) and the names seen go into the run's record under
``spans``, where the per-layer metrics read them; the record of ``run``
holds that dict from the start, and ``profile`` fills it.

Parameters, from the cell's file: ``closed_ticks``' own.
"""
from __future__ import annotations

from bench import spans as spans_mod
from bench.traffic import closed_ticks
from bench.traffic.closed_ticks import warm

# the program's spans the reduction follows (``repro_torch.tracing``)
PROGRAM = ("split.edge", "codec.encode", "split.server", "codec.decode",
           "server.apply", "lm.edge", "lm.server", "attn", "ssm",
           "ssm.proj", "ssm.scan", "ssm.out", "moe", "moe.route",
           "moe.permute", "moe.experts", "moe.combine", "moe.shared")


def run(system, params: dict, seconds: float, seed: int) -> dict:
    """``closed_ticks.run``; its record holds an empty ``spans`` dict that
    a later ``profile`` of the same system fills."""
    rec = closed_ticks.run(system, params, seconds, seed)
    rec["spans"] = system.span_record = {}
    return rec


def reduce(events: list) -> dict:
    """The per-tick readings of a trace over the program's and the
    harness's spans: ``device_ms`` and ``idle_ms`` by span, ``ticks`` and
    ``seen``; empty where the trace holds no device operation."""
    red = spans_mod.reduce_nested(events, PROGRAM + spans_mod.HARNESS)
    n = red["ticks"]
    if not n or not red["ops"]:
        return {}
    return {"ticks": n, "seen": red["seen"],
            "device_ms": {k: v / n / 1e3
                          for k, v in red["device_us"].items()},
            "idle_ms": {k: v / n / 1e3 for k, v in red["idle_us"].items()}}


def profile(system, params: dict, device_type: str) -> dict:
    """``closed_ticks.profile`` with the program's tracing on; fills the
    last record's ``spans`` (``run``) and returns the trace's events."""
    from repro_torch import tracing
    tracing.enable()
    try:
        out = closed_ticks.profile(system, params, device_type)
    finally:
        tracing.disable()
        tracing.records()
    target = getattr(system, "span_record", None)
    if target is not None:
        target.update(reduce(out.get("events", [])))
    return out


__all__ = ["PROGRAM", "profile", "reduce", "run", "warm"]
