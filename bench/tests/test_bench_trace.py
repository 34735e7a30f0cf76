"""The trace reduction and the per-layer readers on a synthetic trace in
Chrome's format, as ``torch.profiler`` exports it."""
import pytest

from bench.tests.tiny import tiny
from bench import harness, trace


def ev(cat, name, ts, dur, corr=None, stream=7):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    if cat in trace.DEVICE_CATS:
        e["args"]["stream"] = stream
    return e


def two_ticks():
    """Two 100 us ticks: the encoder (its launch not recorded), a codec
    kernel overlapping it, a GEMM, a copy."""
    out = []
    for t0, c in ((0.0, 10), (100.0, 20)):
        out += [
            ev("user_annotation", "tick", t0, 100),
            ev("user_annotation", "edge", t0 + 1, 20),
            ev("user_annotation", "server", t0 + 22, 10),
            ev("user_annotation", "fetch", t0 + 33, 3),
            ev("user_annotation", "wait", t0 + 37, 60),
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 10, 2, c + 1),
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 25, 2, c + 2),
            ev("cuda_runtime", "cudaMemcpyAsync", t0 + 34, 2, c + 3),
            ev("kernel", "encoder_stream_kernel(Params)", t0 + 5, 50, c),
            ev("kernel", "amin_kernel", t0 + 50, 10, c + 1),
            ev("kernel", "gemm", t0 + 60, 20, c + 2),
            ev("gpu_memcpy", "Memcpy DtoH", t0 + 80, 5, c + 3),
        ]
    return out


def test_reduce_unions_and_attributes():
    red = trace.reduce(two_ticks())
    assert red["ticks"] == 2 and red["window_us"] == 200
    # per tick: [5, 60) and [60, 85): 80 us busy, not the 85 us summed
    assert red["busy_us"] == pytest.approx(160)
    spans = [s for _, _, _, s in red["ops"]]
    assert spans == ["edge", "edge", "server", "fetch"] * 2
    assert sum(red["idle_by_span"].values()) == pytest.approx(40)
    # each tick: idle 0-5 us (host in the tick 1, in edge 4) and 85-100
    # (in wait 12, in the tick 3)
    assert red["idle_by_span"] == pytest.approx({"wait": 24, "tick": 8,
                                                 "edge": 8})
    b = trace.breakdown(red)
    assert b["device_ops"][0] == ["encoder_stream_kernel(Params)", 1e-4]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_union_clips_to_the_window():
    assert trace.union_us([(0, 10), (5, 20), (30, 40)], 2, 35) == 23
    assert trace.union_us([], 0, 10) == 0


def test_readers_on_a_synthetic_record():
    _, cell, config = tiny("mc84.envs256")
    config["manifest"]["h"] = 84
    red = trace.reduce(two_ticks())
    rec = {"trace": red, "ticks": 1000, "units": 256000, "window_s": 1.0,
           "host_dispatch_s": 0.3, "config": config, "units_per_tick": 256,
           "device_kind": "NVIDIA H100 80GB HBM3", "lat_s": [1e-3] * 100,
           "setup_s": 5.0}
    read = {m: harness.load_reader(m).read(rec) for m in (
        "edge_device_ms", "server_device_ms", "device_idle",
        "kernels_per_tick", "encoder_roofline", "host_ms_per_tick",
        "decision_mfu", "decisions_per_s", "decision_ms_p95", "setup_s")}
    assert read["edge_device_ms"] == pytest.approx(0.060)
    assert read["server_device_ms"] == pytest.approx(0.020)
    assert read["device_idle"] == pytest.approx(20.0)
    assert read["kernels_per_tick"] == 4
    # 256 frames x 13,009,536 FLOP / 67 TFLOP/s over 50 us of encoder
    assert read["encoder_roofline"] == pytest.approx(
        256 * 13_009_536 / 67e12 / 50e-6 * 100)
    assert read["host_ms_per_tick"] == pytest.approx(0.3)
    assert read["decision_mfu"] == pytest.approx(
        256000 * (13_009_536 + 495_616) / 67e12 * 100)
    assert read["decisions_per_s"] == 256000
    assert read["decision_ms_p95"] == pytest.approx(1.0)
    rec["trace"] = trace.reduce([])
    assert harness.load_reader("device_idle").read(rec) is None
    assert harness.load_reader("encoder_roofline").read(rec) is None
