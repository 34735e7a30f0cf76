"""The program's own spans (``repro_torch.tracing``) in one benchmark cell.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s>

Run from the root of a checkout, on a card.  It builds the cell as
``bench/run.py`` does and warms it, then:

1. the untraced stretch: ``--seconds`` of the cell's closed loop with the
   program's tracing off, as the benchmark's traced run has it
   (``host_ms_per_tick``);
2. the program stretch: ``10 x trace_ticks`` ticks with the program's
   tracing on and no profiler: each span's host ms and self ms a tick
   (``encoder_host_ms``), and the dispatch's host ms a tick with tracing
   on, against the untraced stretch's;
3. the spans window: the traffic's profiled stretch (``trace_ticks``
   ticks, the harness's ``tick``/``edge``/``server``/``fetch``/``wait``
   spans) with the program's tracing on, reduced over both sets of spans
   at any depth: device idle ms and device ms a tick under each span
   (``encoder_idle_ms``, ``codec_device_ms``);
4. tracing's cost: the host µs a tick of the split path's nine span
   calls alone, with tracing off and on.

It prints one JSON line.  On the CPU (``device="cpu"``, as the tests run
it) every time is reported as not measured.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import harness  # noqa: E402
from bench.trace import (DEVICE_CATS, HOST_CATS, SPANS, _corr,  # noqa: E402
                         _gaps, union_us)
from repro_torch import tracing  # noqa: E402

# the split path's spans, outermost first (``repro_torch.tracing``)
PROGRAM = ("split.edge", "encoder", "encoder.check", "encoder.prepare",
           "encoder.launch", "codec.encode", "split.server", "codec.decode",
           "server.apply")
HARNESS = ("tick",) + SPANS


class Nest:
    """Named host spans that nest to any depth, and which of them holds a
    host time."""

    def __init__(self, spans):
        # outer spans first where two start together
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.parent: list = []
        stack: list = []
        for i, (_, e, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def chain(self, t: float) -> tuple:
        """The names of the spans holding ``t``, innermost first: the last
        span to start at or before ``t``, or the nearest of its enclosing
        spans that has not ended."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j is not None and j >= 0 and self.spans[j][1] < t:
            j = self.parent[j]
        out = []
        while j is not None and j >= 0:
            out.append(self.spans[j][2])
            j = self.parent[j]
        return tuple(out)


def _common(a: tuple, b: tuple) -> tuple:
    """The enclosing spans two chains share (innermost first)."""
    n = 0
    for x, y in zip(reversed(a), reversed(b)):
        if x != y:
            break
        n += 1
    return a[len(a) - n:]


def reduce_nested(events: list, names) -> dict:
    """Device time and idle time of a ``torch.profiler`` trace by the
    spans named in ``names`` (and ``tick``), at any depth.

    Returns ``ticks``, ``window_us`` (first tick's start to last tick's
    end), ``busy_us`` (union of device operations), ``ops``,
    ``device_us`` and ``idle_us`` (by every span holding the host at the
    operation's launch, or during the idle stretch) and
    ``device_self_us`` and ``idle_self_us`` (by the innermost one;
    ``loop`` outside every tick), and ``seen``, the names of the spans the
    trace holds.  An operation whose launch the trace did not record was
    launched between the recorded launches before and after it on its
    stream: it takes the spans both of them were in."""
    ticks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "tick"]
    out = {"ticks": len(ticks), "window_us": 0.0, "busy_us": 0.0, "ops": 0,
           "device_us": {}, "device_self_us": {}, "idle_us": {},
           "idle_self_us": {}, "seen": []}
    if not ticks:
        return out
    lo = min(e["ts"] for e in ticks)
    hi = max(e["ts"] + e["dur"] for e in ticks)
    tids = {e.get("tid") for e in ticks}
    wanted = set(names) | {"tick"}
    nest = Nest([(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e.get("name") in wanted and e.get("tid") in tids])
    launch = {_corr(e): e["ts"] for e in events
              if e.get("cat") in HOST_CATS and _corr(e) is not None}
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
    chains = [nest.chain(launch[_corr(e)]) if _corr(e) in launch else None
              for e in dev]
    by_stream: dict = {}
    for i, e in enumerate(dev):
        by_stream.setdefault((e.get("args") or {}).get("stream"),
                             []).append(i)
    for idx in by_stream.values():
        known = [i for i in idx if chains[i] is not None]
        for i in idx:
            if chains[i] is not None:
                continue
            k = bisect.bisect_left(known, i)
            before = chains[known[k - 1]] if k else None
            after = chains[known[k]] if k < len(known) else None
            chains[i] = (_common(before, after)
                         if before is not None and after is not None
                         else before or after or ())
    for e, chain in zip(dev, chains):
        _add(out["device_self_us"], chain[0] if chain else "loop", e["dur"])
        for name in set(chain):
            _add(out["device_us"], name, e["dur"])
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    bounds = sorted({t for s, e, _ in nest.spans for t in (s, e)})
    for s, e in _gaps(intervals, lo, hi):
        cuts = bounds[bisect.bisect_right(bounds, s):
                      bisect.bisect_left(bounds, e)]
        for a, b in zip([s] + cuts, cuts + [e]):
            chain = nest.chain((a + b) / 2)
            _add(out["idle_self_us"], chain[0] if chain else "loop", b - a)
            for name in set(chain):
                _add(out["idle_us"], name, b - a)
    out.update(window_us=hi - lo, busy_us=union_us(intervals, lo, hi),
               ops=len(dev), seen=sorted({n for _, _, n in nest.spans}))
    return out


def _add(d: dict, k, v) -> None:
    d[k] = d.get(k, 0.0) + v


def program_stretch(system, ticks: int) -> dict:
    """``ticks`` ticks of the closed loop with the program's tracing on,
    no profiler: the records (each outermost span's request is its tick)
    and the dispatch's host seconds, timed as the benchmark's window
    times them."""
    tracing.records()
    host = 0.0
    now = time.perf_counter
    tracing.enable()
    try:
        for i in range(ticks):
            tracing.request(i)
            t0 = now()
            system.dispatch(i)
            host += now() - t0
            system.wait()
    finally:
        tracing.disable()
    return {"ticks": ticks, "host_dispatch_s": host,
            "records": tracing.records()}


def spans_window(system, traffic, params: dict, device_type: str) -> dict:
    """The traffic's profiled stretch with the program's tracing on,
    reduced over the program's and the harness's spans."""
    tracing.enable()
    try:
        events = traffic.profile(system, params, device_type)["events"]
    finally:
        tracing.disable()
        tracing.records()
    return reduce_nested(events, PROGRAM + HARNESS)


def span_cost_us(on: bool = False, n: int = 3000,
                 repeats: int = 7) -> float:
    """Host µs a tick of the split path's nine span calls, nested and
    called as in a tick, with the program's tracing off or ``on`` (no
    profiler): the median over ``repeats`` of the mean over ``n`` ticks."""
    now = time.perf_counter
    out = []
    for _ in range(repeats):
        if on:
            tracing.enable()
        t0 = now()
        for _ in range(n):
            with tracing.span("split.edge"):
                with tracing.span("encoder"):
                    with tracing.span("encoder.check"):
                        pass
                    with tracing.span("encoder.prepare"):
                        pass
                    with tracing.span("encoder.launch"):
                        pass
                with tracing.span("codec.encode"):
                    pass
            with tracing.span("split.server"):
                with tracing.span("codec.decode"):
                    pass
                with tracing.span("server.apply"):
                    pass
        out.append((now() - t0) / n * 1e6)
        tracing.disable()
        tracing.records()
    return statistics.median(out)


def summarize(stretch: dict, window: dict) -> dict:
    """``program_spans`` (each span's host and self ms a tick over the
    program stretch, idle and device ms a tick in the spans window),
    ``harness_spans`` (idle and device ms a tick of the harness's spans in
    the same window) and the three per-layer readings: ``encoder_host_ms``,
    ``encoder_idle_ms``, ``codec_device_ms``.  A reading whose source is
    missing is None."""
    recs = stretch.get("records") or []
    n = stretch.get("ticks") or 0
    host: dict = {}
    own: dict = {}
    for r, s in zip(recs, tracing.self_times(recs)):
        _add(host, r[0], r[2] - r[1])
        _add(own, r[0], s)
    w = (window.get("ticks") or 0) if window.get("ops") else 0
    seen = set(window.get("seen", ()))

    def per_tick(d: dict, k, scale: float, ticks: int, has: bool):
        return d.get(k, 0.0) / ticks / scale if ticks and has else None

    def in_window(k):
        return {"idle_ms": per_tick(window.get("idle_us", {}), k, 1e3, w,
                                    k in seen),
                "device_ms": per_tick(window.get("device_us", {}), k, 1e3,
                                      w, k in seen)}

    prog = {k: {"host_ms": per_tick(host, k, 1e6, n, k in host),
                "self_ms": per_tick(own, k, 1e6, n, k in host),
                **in_window(k)}
            for k in PROGRAM}
    codec = [prog[k]["device_ms"] for k in ("codec.encode", "codec.decode")]
    return {"program_spans": prog,
            "harness_spans": {k: in_window(k) for k in HARNESS},
            "metrics": {"encoder_host_ms": prog["encoder"]["host_ms"],
                        "encoder_idle_ms": prog["encoder"]["idle_ms"],
                        "codec_device_ms": None if None in codec
                        else sum(codec)}}


def run(name: str, seed: int, seconds: float, *, device: str = "cuda",
        cells=None, out=None) -> int:
    """Measure ``name`` (module docstring); returns the exit code."""
    out = out or sys.stdout
    _, cell, config = cells or harness.load_cell(name)
    dev = torch.device(device)
    dry = dev.type != "cuda"
    if not dry and not torch.cuda.is_available():
        print(f"{name}: needs a CUDA device", file=sys.stderr)
        return 2
    system_mod, ref, traffic = harness.modules(config, cell)
    params = cell["params"]
    system = system_mod.System(config, cell, dev)
    system.bind(ref.make_inputs(config, params, seed, dev))
    traffic.warm(system, params)
    gc.collect()
    gc.freeze()
    rec = traffic.run(system, params, seconds, seed)
    stretch = program_stretch(system, 10 * params["trace_ticks"])
    window = spans_window(system, traffic, params, dev.type)
    cost = {"off": span_cost_us(), "on": span_cost_us(on=True)}
    system.close()
    gc.unfreeze()
    res = summarize(stretch, window)
    counts: dict = {}
    for r in stretch["records"]:
        _add(counts, r[0], 1)
    line = {"workload": name, "seed": seed,
            "card": "" if dry else harness.power_limit(),
            "device_kind": torch.cuda.get_device_name(dev) if not dry
            else "cpu",
            "spans_per_tick": {k: v / stretch["ticks"]
                               for k, v in counts.items()}}
    if dry:
        note = "not measured: CPU dry run"
        line.update(program_spans={k: note for k in PROGRAM},
                    metrics={k: note for k in res["metrics"]})
    else:
        line.update(
            host_ms_per_tick=rec["host_dispatch_s"] / rec["ticks"] * 1e3,
            traced_host_ms_per_tick=stretch["host_dispatch_s"]
            / stretch["ticks"] * 1e3,
            span_us_per_tick=cost,
            window={"ticks": window["ticks"],
                    "device_idle": (1 - window["busy_us"]
                                    / window["window_us"]) * 100
                    if window["window_us"] else None,
                    "idle_self_ms": {k: v / window["ticks"] / 1e3
                                     for k, v in
                                     window["idle_self_us"].items()}},
            **res)
    print(json.dumps(line), file=out)
    out.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The program's spans in one cell, as one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    a = ap.parse_args(argv)
    return run(a.workload, a.seed, a.seconds)


__all__ = ["HARNESS", "Nest", "PROGRAM", "main", "program_stretch",
           "reduce_nested", "run", "span_cost_us", "spans_window",
           "summarize"]


if __name__ == "__main__":
    sys.exit(main())


