"""One split decision of an LM at full width on the card: edge, server
and monolith time per decision, and what a trace of one decision shows.

    python -m repro_torch.benchmarks.lm_split [--arch qwen2-moe-a2.7b]

It builds ``launch.serve.build_split(arch, reduced=False,
edge_segments=1, codec_name="uint8", batch=1, seq=128)`` on CUDA (random
weights from seed 0; ``--arch`` defaults to qwen3-0.6b and takes any
config but whisper-medium, whose encoder–decoder ``build_split`` refuses
as the reference does, and llama4-scout-17b-a16e, which no single card
holds), then three times
measures the edge, the server half and the monolith in turn, each over 20
calls after a warm-up, ended by a synchronize: the wall clock (``*_ms``,
as ``PolicyServer.measure`` reads it) and the calling thread's CPU time
(``*_cpu_ms``).  The decision is host-bound, and on a host shared with
other jobs the wall clock also counts the time the thread waits for a
core; its CPU time does not.

Last it traces one decision (edge + server) with ``trace_decision``,
which ``chip_smoke.py`` uses too.  It prints one line a repeat, then one
JSON object with every number and the card's name.

It imports only ``repro_torch`` from the path, so the same file times
another checkout's package, e.g. a parent commit unpacked beside this
one: ``PYTHONPATH=<other>/src python <this file>``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import ARCHS

SEQ, REPEATS = 128, 3


def trace_decision(fn) -> dict:
    """A torch.profiler trace of one call of ``fn`` (after one untraced):
    the kernels launched, the device's busy ms (the sum of its kernels'
    device time), the traced call's wall ms (the profiler's own host cost
    included), K5's launches and device us a launch (None when it ran no
    time) and the four kernels of most device time as (name, launches,
    ms).  ``kernels`` is 0 when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    k5 = [e for e in kern if "flash_kernel" in e.key]
    n_k5 = sum(e.count for e in k5)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:4]
    return dict(kernels=sum(e.count for e in kern),
                busy_ms=sum(e.self_device_time_total for e in kern) / 1e3,
                traced_wall_ms=wall_ms, k5_launches=n_k5,
                k5_device_us=(sum(e.self_device_time_total for e in k5)
                              / n_k5) if n_k5 else None,
                top=[(e.key, e.count, e.self_device_time_total / 1e3)
                     for e in top])


def timed(fn, arg, iters: int = 20) -> tuple[float, float]:
    """(wall ms, thread CPU ms) a call of ``fn(arg)``, over ``iters`` calls
    after one warm-up call, ended by a synchronize."""
    fn(arg)
    torch.cuda.synchronize()
    w0, c0 = time.perf_counter(), time.thread_time()
    for _ in range(iters):
        fn(arg)
    torch.cuda.synchronize()
    return ((time.perf_counter() - w0) / iters * 1e3,
            (time.thread_time() - c0) / iters * 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    arch = ap.parse_args(argv).arch
    if not torch.cuda.is_available():
        raise SystemExit("lm_split: CUDA is not available")
    from repro_torch.launch import serve

    _, edge_fn, server_fn, mono_fn, _, _, _ = serve.build_split(
        arch, reduced=False, edge_segments=1, codec_name="uint8", batch=1,
        seq=SEQ)
    gen = torch.Generator().manual_seed(13)
    tokens = torch.randint(3, 1000, (1, SEQ), generator=gen).to(
        "cuda", torch.int32)
    payload = edge_fn(tokens)
    rows = []
    for i in range(REPEATS):
        row = {}
        for name, fn, arg in (("edge", edge_fn, tokens),
                              ("server", server_fn, payload),
                              ("monolith", mono_fn, tokens)):
            row[f"{name}_ms"], row[f"{name}_cpu_ms"] = timed(fn, arg)
        rows.append(row)
        print(f"repeat {i}: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in row.items()),
              flush=True)
    traced = trace_decision(lambda: server_fn(edge_fn(tokens)))
    print(json.dumps(dict(arch=arch, seq=SEQ,
                          device=torch.cuda.get_device_name(0),
                          repeats=rows, trace=traced)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
