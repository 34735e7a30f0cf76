"""``bench/spans.py``: the reduction of a trace over spans nested five
deep, fourteen a tick; the per-layer readings it gives; and a dry run of
a tiny cell on the CPU."""
import io
import json

import pytest

from bench import spans, trace
from bench.tests.test_bench_trace import ev, two_ticks
from bench.tests.tiny import tiny

SPAN_TIMES = [("tick", 0, 100), ("edge", 1, 30), ("split.edge", 2, 28),
              ("encoder", 3, 17), ("encoder.check", 4, 2),
              ("encoder.prepare", 7, 5), ("encoder.launch", 13, 5),
              ("codec.encode", 21, 8), ("server", 32, 10),
              ("split.server", 33, 8), ("codec.decode", 34, 2),
              ("server.apply", 37, 3), ("fetch", 43, 3), ("wait", 47, 50)]


def nested_ticks(n=2):
    """``n`` 100 us ticks of the split path's spans inside the harness's
    (five deep: tick, edge, split.edge, encoder, encoder.check): a fill
    launched in ``encoder.prepare``, K4 (its launch not recorded), a
    codec kernel each way, the GEMM, the copy."""
    out = []
    for k in range(n):
        t0, c = 100.0 * k, 10 * (k + 1)
        out += [ev("user_annotation", name, t0 + s, d)
                for name, s, d in SPAN_TIMES]
        out += [
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 10, 1, c + 1),
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 25, 1, c + 2),
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 35, 1, c + 3),
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 38, 1, c + 4),
            ev("cuda_runtime", "cudaMemcpyAsync", t0 + 44, 1, c + 5),
            ev("kernel", "fill", t0 + 12, 2, c + 1),
            ev("kernel", "encoder_stream_kernel(Params)", t0 + 16, 50, c),
            ev("kernel", "amin_kernel", t0 + 66, 10, c + 2),
            ev("kernel", "decode", t0 + 76, 4, c + 3),
            ev("kernel", "gemm", t0 + 80, 10, c + 4),
            ev("gpu_memcpy", "Memcpy DtoH", t0 + 90, 5, c + 5),
        ]
    return out


def test_nested_reduction_at_any_depth():
    red = spans.reduce_nested(nested_ticks(),
                              spans.PROGRAM + spans.HARNESS)
    assert red["ticks"] == 2 and red["window_us"] == 200 and red["ops"] == 12
    assert len(red["seen"]) == 14
    # per tick: busy [12, 14) and [16, 95); idle 12 + 2 + 5 us
    assert red["busy_us"] == pytest.approx(2 * 81)
    half = {k: v / 2 for k, v in red["idle_self_us"].items()}
    assert half == pytest.approx({
        "tick": 4, "edge": 1, "split.edge": 1, "encoder": 2,
        "encoder.check": 2, "encoder.prepare": 5, "encoder.launch": 2,
        "wait": 2})
    incl = {k: v / 2 for k, v in red["idle_us"].items()}
    assert incl == pytest.approx({
        "tick": 19, "edge": 13, "split.edge": 12, "encoder": 11,
        "encoder.check": 2, "encoder.prepare": 5, "encoder.launch": 2,
        "wait": 2})
    # K4's launch is not in the trace: it lies between the fill's (in
    # encoder.prepare) and the codec's (in codec.encode), so it takes
    # split.edge, the span both were in
    dev = {k: v / 2 for k, v in red["device_us"].items()}
    assert dev == pytest.approx({
        "tick": 81, "edge": 62, "split.edge": 62, "encoder": 2,
        "encoder.prepare": 2, "codec.encode": 10, "server": 14,
        "split.server": 14, "codec.decode": 4, "server.apply": 10,
        "fetch": 5})
    own = {k: v / 2 for k, v in red["device_self_us"].items()}
    assert own == pytest.approx({
        "encoder.prepare": 2, "split.edge": 50, "codec.encode": 10,
        "codec.decode": 4, "server.apply": 10, "fetch": 5})


def test_nested_reduction_keeps_the_harness_reading():
    """Over the harness's spans alone it splits idle time as
    ``trace.reduce`` does."""
    got = spans.reduce_nested(two_ticks(), spans.HARNESS)
    want = trace.reduce(two_ticks())
    assert got["idle_self_us"] == pytest.approx(want["idle_by_span"])
    assert got["busy_us"] == want["busy_us"]
    assert got["window_us"] == want["window_us"]
    assert spans.reduce_nested([], spans.HARNESS)["ticks"] == 0


def test_nest_finds_the_innermost_span():
    nest = spans.Nest([(0, 100, "a"), (10, 20, "b"), (12, 14, "c"),
                       (30, 40, "d"), (30, 35, "e"), (50, 60, "f")])
    assert nest.chain(13) == ("c", "b", "a")
    assert nest.chain(16) == ("b", "a")
    assert nest.chain(37) == ("d", "a")
    assert nest.chain(32) == ("e", "d", "a")
    assert nest.chain(45) == ("a",)
    assert nest.chain(101) == () and nest.chain(-1) == ()


def _records(ticks=2):
    """Program-stretch records of ``ticks`` ticks, times in ns."""
    out = []
    for k in range(ticks):
        t0, base = 10_000 * k, len(out)
        rel = {"split.edge": None, "encoder": 0, "encoder.check": 1,
               "encoder.prepare": 1, "encoder.launch": 1,
               "codec.encode": 0, "split.server": None,
               "codec.decode": 6, "server.apply": 6}
        times = {"split.edge": (0, 5000), "encoder": (100, 4000),
                 "encoder.check": (200, 700), "encoder.prepare": (800, 2800),
                 "encoder.launch": (2900, 3900),
                 "codec.encode": (4100, 4900),
                 "split.server": (5000, 6000), "codec.decode": (5100, 5300),
                 "server.apply": (5400, 5900)}
        for name, p in rel.items():
            s, e = times[name]
            out.append((name, t0 + s, t0 + e,
                        None if p is None else base + p, k))
    return out


def test_summarize_gives_the_three_readings():
    stretch = {"ticks": 2, "records": _records()}
    window = spans.reduce_nested(nested_ticks(),
                                 spans.PROGRAM + spans.HARNESS)
    got = spans.summarize(stretch, window)
    m = got["metrics"]
    assert m["encoder_host_ms"] == pytest.approx(3900e-6)
    assert m["encoder_idle_ms"] == pytest.approx(11e-3)
    assert m["codec_device_ms"] == pytest.approx(14e-3)
    p = got["program_spans"]
    assert p["encoder"]["self_ms"] == pytest.approx((3900 - 3500) * 1e-6)
    assert p["split.edge"]["self_ms"] == pytest.approx(
        (5000 - 3900 - 800) * 1e-6)
    assert p["encoder.launch"]["device_ms"] == 0
    assert p["encoder.launch"]["idle_ms"] == pytest.approx(2e-3)
    assert got["harness_spans"]["edge"]["device_ms"] == pytest.approx(
        p["split.edge"]["device_ms"])


def test_summarize_is_none_where_its_sources_are_missing():
    empty = spans.summarize({}, spans.reduce_nested([], spans.HARNESS))
    assert set(empty["metrics"].values()) == {None}
    # a trace of the harness's spans alone, as a program without the
    # tracer gives it
    old = spans.summarize({"ticks": 2, "records": []},
                          spans.reduce_nested(two_ticks(), spans.HARNESS))
    assert set(old["metrics"].values()) == {None}
    assert old["harness_spans"]["edge"]["idle_ms"] is not None


@pytest.mark.parametrize("name", ["mc84.envs256", "mc400.cam64"])
def test_dry_run_counts_the_spans(name):
    out = io.StringIO()
    rc = spans.run(name, 2**40 + 3, 0.2, device="cpu", cells=tiny(name),
                   out=out)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    # on the CPU the wrapper takes the plain version after its check
    assert line["spans_per_tick"] == {
        k: 1.0 for k in spans.PROGRAM
        if k not in ("encoder.prepare", "encoder.launch")}
    assert set(line["metrics"]) == {"encoder_host_ms", "encoder_idle_ms",
                                    "codec_device_ms"}
    assert all(v.startswith("not measured")
               for v in line["metrics"].values())
    assert line["device_kind"] == "cpu" and line["card"] == ""


def test_span_cost_leaves_tracing_off():
    tracing = spans.tracing
    for on in (False, True):
        assert spans.span_cost_us(on=on, n=10, repeats=1) > 0
    assert tracing.records() == []
    with tracing.span("x"):
        pass
    assert tracing.records() == []
