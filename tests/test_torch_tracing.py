"""``repro_torch.tracing`` on the CPU: off it records nothing and calls no
profiler function; on, the split path's spans nest as the deployment calls
them, carry the caller's request id, land in a ``torch.profiler`` trace,
and ``self_times`` takes each span's children out of its time."""
import json
import threading

import pytest

pytest.importorskip("torch")

import torch

from repro_torch import tracing
from repro_torch.deploy import Deployment, DeploymentConfig

torch.set_num_threads(1)

SPANS = {"split.edge", "encoder", "encoder.check", "codec.encode",
         "split.server", "codec.decode", "server.apply"}


@pytest.fixture
def traced():
    tracing.records()
    yield tracing
    tracing.disable()
    tracing.records()


@pytest.fixture(scope="module")
def dep():
    """A fused deployment at 24x24x12, 4 frames a call, with its params
    and frames."""
    cfg = DeploymentConfig.standard(k=4, c_in=12, h=24, backend="fused",
                                    head_dim=8, max_batch=4)
    d = Deployment.build(cfg, device="cpu")
    params = d.init(torch.Generator().manual_seed(0))
    obs = torch.rand((4, 24, 24, 12),
                     generator=torch.Generator().manual_seed(1))
    return d, params, obs


def _tick(d, params, obs):
    with torch.inference_mode():
        payload = d.split.edge_step_batch(params["edge"], obs)
        return d.split.server_step_batch(params["server"], payload)


def test_off_records_nothing_and_calls_no_profiler(dep, traced,
                                                   monkeypatch):
    calls = []
    monkeypatch.setattr(tracing, "_profiler_enabled",
                        lambda: calls.append("enabled") or True)
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: calls.append(name))
    _tick(*dep)
    assert tracing.records() == [] and calls == []
    # one shared object, whatever the name
    assert tracing.span("a") is tracing.span("b")


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_spans_let_exceptions_through(traced, on):
    if on:
        tracing.enable()
    with pytest.raises(ValueError, match="inside"):
        with tracing.span("outer"):
            with tracing.span("inner"):
                raise ValueError("inside")
    with tracing.span("after"):
        pass
    tracing.disable()
    recs = tracing.records()
    assert [(r[0], r[3]) for r in recs] == ([
        ("outer", None), ("inner", 0), ("after", None)] if on else [])
    assert all(r[1] <= r[2] for r in recs)


def test_on_gives_the_split_tree(dep, traced):
    d, params, obs = dep
    off = _tick(d, params, obs)
    tracing.enable()
    tracing.request(7)
    on = _tick(d, params, obs)
    tracing.request(8)
    _tick(d, params, obs)
    tracing.disable()
    assert torch.equal(on, off)
    recs = tracing.records()
    assert tracing.records() == []
    names = [r[0] for r in recs]
    assert names == ["split.edge", "encoder", "encoder.check",
                     "codec.encode", "split.server", "codec.decode",
                     "server.apply"] * 2
    for i, (name, t0, t1, parent, req) in enumerate(recs):
        assert 0 < t0 <= t1
        assert req == (7 if i < 7 else 8)
        if parent is not None:
            assert parent < i
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2]
    tree = {recs[i][0]: (recs[p][0] if p is not None else None)
            for i, (_, _, _, p, _) in enumerate(recs[:7])}
    assert tree == {"split.edge": None, "encoder": "split.edge",
                    "encoder.check": "encoder", "codec.encode": "split.edge",
                    "split.server": None, "codec.decode": "split.server",
                    "server.apply": "split.server"}


@pytest.mark.parametrize("chunk", [None, 2])
def test_each_encoder_wrapper_checks_inside_encoder(dep, traced, chunk):
    """K1's wrapper (no chunk) and K4's (2-frame chunks of 4 frames) each
    open one ``encoder.check`` under ``encoder``; on the CPU they take
    the plain version after it, so no ``encoder.prepare`` or
    ``encoder.launch``."""
    from repro_torch.core.miniconv import miniconv_apply
    d, params, obs = dep
    tracing.enable()
    miniconv_apply(params["edge"], d.spec, obs, use_kernel="fused",
                   plan=d.plan, stream_chunk=chunk)
    tracing.disable()
    recs = tracing.records()
    assert [(r[0], r[3]) for r in recs] == [("encoder", None),
                                            ("encoder.check", 0)]


def test_request_goes_to_the_outermost_spans():
    tracing.records()
    tracing.enable()
    try:
        tracing.request("r1")
        with tracing.span("a"):
            tracing.request("ignored")
            with tracing.span("b"):
                pass
        tracing.request(None)
        with tracing.span("c"):
            pass
    finally:
        tracing.disable()
    assert [(r[0], r[3], r[4]) for r in tracing.records()] == [
        ("a", None, "r1"), ("b", 0, "r1"), ("c", None, None)]


def test_threads_keep_their_own_nesting():
    tracing.records()
    tracing.enable()
    go = threading.Barrier(2, timeout=30)

    def worker(tag):
        tracing.request(tag)
        with tracing.span(f"outer.{tag}"):
            go.wait()
            with tracing.span(f"inner.{tag}"):
                go.wait()
    try:
        ts = [threading.Thread(target=worker, args=(t,)) for t in "xy"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        tracing.disable()
    recs = tracing.records()
    assert len(recs) == 4
    for i, (name, _, _, parent, req) in enumerate(recs):
        kind, tag = name.split(".")
        assert req == tag
        if kind == "outer":
            assert parent is None
        else:
            assert recs[parent][0] == f"outer.{tag}"


def test_spans_land_in_the_profiler_trace(dep, traced, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    d, params, obs = dep
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _tick(d, params, obs)
    tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = [e for e in events if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in got} == SPANS
    by = {e["name"]: e for e in got}
    outer, inner = by["split.edge"], by["encoder.check"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert len(tracing.records()) == len(SPANS)


def test_profiler_off_enters_no_record_function(dep, traced, monkeypatch):
    entered = []
    real = tracing.record_function
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: entered.append(name) or real(name))
    tracing.enable()
    _tick(*dep)
    tracing.disable()
    assert entered == [] and len(tracing.records()) == len(SPANS)


def test_self_times_subtract_the_children():
    recs = [("tick", 0, 100, None, 0), ("a", 10, 60, 0, 0),
            ("b", 20, 30, 1, 0), ("c", 35, 55, 1, 0), ("d", 70, 90, 0, 0),
            ("next", 100, 110, None, 1)]
    assert tracing.self_times(recs) == [30, 20, 10, 20, 20, 10]
    assert tracing.self_times([]) == []
