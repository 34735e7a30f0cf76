"""``closed_ticks_spans``' closed loop of decision ticks over the spans of
the multi-head latent attention LM path: the program's spans it reduces
hold, beside ``closed_ticks_spans``' own, ``mla`` (each MLA mixer) and
its parts ``mla.q``, ``mla.kv``, ``mla.rope``, ``mla.core`` (K5) and
``mla.out``, and ``mlp`` (the dense layer's FFN).

``warm`` and ``run`` are ``closed_ticks_spans``'.  ``profile`` runs
``closed_ticks``' profiled ticks with the program's tracing on and reduces
the trace over this file's ``PROGRAM`` and the harness's spans at any
depth (``bench.spans.reduce_nested``), into the run's record under
``spans``, where the per-layer metrics read them.

Parameters, from the cell's file: ``closed_ticks``' own.
"""
from __future__ import annotations

from bench import spans as spans_mod
from bench.traffic import closed_ticks, closed_ticks_spans
from bench.traffic.closed_ticks_spans import run, warm

# the program's spans the reduction follows (``repro_torch.tracing``)
PROGRAM = closed_ticks_spans.PROGRAM + (
    "mla", "mla.q", "mla.kv", "mla.rope", "mla.core", "mla.out", "mlp")


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
