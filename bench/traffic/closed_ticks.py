"""Closed loop of decision ticks.

One tick is ``frames_per_tick`` clients deciding together (the vectorised
environments of an RL run, the members of a population, cameras served at
one control step): the system decides the tick's batch and the next tick
starts when the outputs are on the host, because the next observation
follows the action.  Tick ``i`` decides pool batch ``i % pool_batches``.

A tick's latency runs from its start (frames ready) to its outputs on the
host; every decision of a tick has its tick's latency.  While it runs,
the loop keeps a uniform sample of ``check_ticks`` ticks' answers
(reservoir sampling, drawn from the seed) for the check after the window.

Parameters, from the cell's file: ``frames_per_tick``, ``pool_batches``,
``warm_ticks``, ``check_ticks``, ``trace_ticks``.
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import time


def warm(system, params: dict) -> None:
    """Run every shape the window will use: ``warm_ticks`` ticks."""
    for i in range(params["warm_ticks"]):
        system.dispatch(i)
        system.wait()


def run(system, params: dict, seconds: float, seed: int) -> dict:
    """Decide ticks for ``seconds``: the window.

    Returns ``ticks``, ``units`` (decisions), ``units_per_tick``,
    ``window_s``, ``lat_s`` (one latency a tick), ``kept`` ((pool index,
    answers) of the sampled ticks) and ``host_dispatch_s``: the host
    clock's seconds from each tick's start until its last operation was
    enqueued, summed (the wait for the device left out)."""
    rng = random.Random(int(seed) % 2**64)
    k = params["check_ticks"]
    kept: list = []
    lat: list = []
    host = 0.0
    n = 0
    now = time.perf_counter
    w0 = now()
    t_end = w0 + seconds
    while True:
        t0 = now()
        idx = system.dispatch(n)
        host += now() - t0
        system.wait()
        t1 = now()
        lat.append(t1 - t0)
        n += 1
        if len(kept) < k:
            kept.append((idx, system.keep()))
        else:
            j = int(rng.random() * n)
            if j < k:
                kept[j] = (idx, system.keep())
        if t1 >= t_end:
            break
    b = params["frames_per_tick"]
    return {"ticks": n, "units": n * b, "units_per_tick": b,
            "window_s": t1 - w0, "lat_s": lat, "kept": kept,
            "host_dispatch_s": host}


def profile(system, params: dict, device_type: str) -> dict:
    """``trace_ticks`` ticks under ``torch.profiler``, after ten ticks the
    profiler runs but discards, with spans around the tick (``tick``) and
    its parts (``edge``, ``server``, ``fetch``, ``wait``).  Returns the
    trace's events as Chrome's trace format lists them."""
    from torch.profiler import (ProfilerActivity, profile as _profile,
                                record_function, schedule)
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = params["trace_ticks"]
    warm_steps = 10
    out: dict = {}

    def ready(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                out["events"] = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)

    with _profile(activities=acts,
                  schedule=schedule(wait=0, warmup=warm_steps, active=n,
                                    repeat=1),
                  on_trace_ready=ready) as prof:
        for i in range(warm_steps + n):
            with record_function("tick"):
                system.dispatch(i, record_function)
                with record_function("wait"):
                    system.wait()
            prof.step()
    return out


__all__ = ["profile", "run", "warm"]
