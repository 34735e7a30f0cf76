"""Reduce a ``torch.profiler`` trace (Chrome's trace format) to what the
per-layer metrics read.

Device operations are the events of category ``kernel``, ``gpu_memcpy``
and ``gpu_memset``.  Each is tied to the host call that launched it by
its correlation id, and takes the span (``edge``, ``server``, ``fetch``,
``wait``) the driving thread was in at that call.  An operation whose
launch the trace did not record takes the span of the next operation on
its stream that has one.  The traced window runs from the first ``tick``
span's start to the last one's end; busy time is the union of the device
operations' intervals inside it, not their sum.  Idle time is split by
the span the host was in (``loop`` outside every tick).
"""
from __future__ import annotations

import bisect

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SPANS = ("edge", "server", "fetch", "wait")


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps of [lo, hi] outside every interval."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class _SpanIndex:
    """Which named span holds a host time."""

    def __init__(self, spans):
        # outer spans first where two start together
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: float):
        """The innermost span holding ``t`` (spans nest at most two deep
        and a tick holds at most five, so eight back is enough)."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            s, e, name = self.spans[j]
            if s <= t <= e:
                return name
        return None


def reduce(events: list) -> dict:
    """``{"ticks", "window_us", "busy_us", "ops", "idle_by_span"}`` of a
    trace; ``ops`` is a list of (name, start_us, dur_us, span) in start
    order.  Empty of device operations where the trace has none."""
    ticks = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "tick"]
    if not ticks:
        return {"ticks": 0, "window_us": 0.0, "busy_us": 0.0, "ops": [],
                "idle_by_span": {}}
    lo, hi = min(s for s, _ in ticks), max(e for _, e in ticks)
    spans = _SpanIndex([(e["ts"], e["ts"] + e["dur"], e["name"])
                        for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("name") in SPANS])
    launch = {_corr(e): e["ts"] for e in events
              if e.get("cat") in HOST_CATS and _corr(e) is not None}
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and lo <= e["ts"] <= hi),
                 key=lambda e: e["ts"])
    named = [spans.at(launch[_corr(e)]) if _corr(e) in launch else None
             for e in dev]
    # an operation without a recorded launch takes the next one's span on
    # its stream (a tick's launches run in order on one stream)
    nxt: dict = {}
    for i in range(len(dev) - 1, -1, -1):
        stream = (dev[i].get("args") or {}).get("stream")
        if named[i] is None:
            named[i] = nxt.get(stream)
        else:
            nxt[stream] = named[i]
    ops = [(e["name"], e["ts"], e["dur"], span or "tick")
           for e, span in zip(dev, named)]
    intervals = [(s, s + d) for _, s, d, _ in ops]
    idle: dict = {}
    host_spans = _SpanIndex([(s, e, "tick") for s, e in ticks]
                            + spans.spans)
    # each idle stretch goes to the innermost span the host was in
    bounds = sorted({t for s, e, _ in host_spans.spans for t in (s, e)})
    for s, e in _gaps(intervals, lo, hi):
        cuts = bounds[bisect.bisect_right(bounds, s):
                      bisect.bisect_left(bounds, e)]
        for a, b in zip([s] + cuts, cuts + [e]):
            name = host_spans.at((a + b) / 2) or "loop"
            idle[name] = idle.get(name, 0.0) + (b - a)
    return {"ticks": len(ticks), "window_us": hi - lo,
            "busy_us": union_us(intervals, lo, hi), "ops": ops,
            "idle_by_span": idle}


def breakdown(red: dict, top: int = 10) -> dict:
    """The device operations of most time and the idle time by what the
    host was doing, in seconds, at most ``top`` of each."""
    by_name: dict = {}
    for name, _, dur, _ in red["ops"]:
        by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(red["idle_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], d / 1e6] for n, d in ops],
            "idle_gaps": [[n, d / 1e6] for n, d in idle]}


__all__ = ["breakdown", "reduce", "union_us"]
