"""The port's latency model, links and break-even benchmark against the
reference.

Everything here is host-side float and numpy arithmetic, so the port must
give the reference's numbers bit for bit on equal inputs and equal seeds:
the latency model on a grid and on hypothesis draws, every registered link
kind's ``send()`` traces (and again after ``reset()``), the simulated
break-even crossover and ``break_even.run()``'s rows.
"""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st

from repro.core import latency as j_lat
from repro.serving import netsim as j_net
from repro_torch import core as t_core
from repro_torch.benchmarks import break_even as t_be
from repro_torch.core import latency as t_lat
from repro_torch.serving import netsim as t_net

ROOT = Path(__file__).resolve().parents[1]


def _load_reference_benchmark(name):
    """The reference's root ``benchmarks/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_bench_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model_numbers(mod, x, n, k, j, bw, rtt, server, action):
    cfg = mod.SplitConfig(x, n, k, j)
    link = mod.LinkModel(bw, rtt)
    return (cfg.frame_bytes, cfg.feature_bytes, mod.break_even_bandwidth(cfg),
            mod.decision_latency_server_only(cfg, link, server_time_s=server,
                                             action_bytes=action),
            mod.decision_latency_split(cfg, link, server_time_s=server,
                                       action_bytes=action),
            link.tx_time(x * 7.5))


@pytest.mark.parametrize("x,n,k,j", list(itertools.product(
    (84, 85, 256, 400), (1, 3), (4, 16), (0.0002, 0.1))))
def test_latency_model_equals_reference_on_grid(x, n, k, j):
    for bw, rtt, server, action in ((10e6, 0.004, 0.0, 64),
                                    (1e9, 0.0, 2.5e-4, 0)):
        assert _model_numbers(t_lat, x, n, k, j, bw, rtt, server, action) \
            == _model_numbers(j_lat, x, n, k, j, bw, rtt, server, action)


@settings(max_examples=60, deadline=None)
@given(x=st.integers(1, 1024), n=st.integers(0, 5), k=st.integers(1, 64),
       j=st.floats(1e-6, 1.0), bw=st.floats(1e3, 1e11),
       rtt=st.floats(0.0, 0.1), server=st.floats(0.0, 0.1),
       action=st.integers(0, 4096))
def test_latency_model_equals_reference_hypothesis(x, n, k, j, bw, rtt,
                                                    server, action):
    assert _model_numbers(t_lat, x, n, k, j, bw, rtt, server, action) \
        == _model_numbers(j_lat, x, n, k, j, bw, rtt, server, action)


@pytest.mark.parametrize("raw,itemsize,edge", [
    (4 << 20, 1.0, 0.004), (1 << 20, 0.5, 0.01), (100, 4.0, 0.001)])
def test_pod_break_even_equals_reference(raw, itemsize, edge):
    def numbers(mod):
        cfg = mod.PodSplitConfig(hidden_bytes_full=2 << 20,
                                 wire_itemsize=itemsize, edge_time_s=edge,
                                 raw_bytes=raw)
        return cfg.wire_bytes, mod.pod_break_even_bandwidth(cfg)
    assert numbers(t_lat) == numbers(j_lat)


def test_core_exports_the_latency_model():
    assert t_core.paper_pi_zero_config() == t_lat.paper_pi_zero_config()
    assert t_core.break_even_bandwidth(t_core.paper_pi_zero_config()) \
        == j_lat.break_even_bandwidth(j_lat.paper_pi_zero_config())
    for name in ("LinkModel", "SplitConfig", "PodSplitConfig",
                 "decision_latency_split", "decision_latency_server_only",
                 "pod_break_even_bandwidth"):
        assert getattr(t_core, name) is getattr(t_lat, name)


# ---------------------------------------------------------------- links
LINK_PARAMS = {
    "static": {"bandwidth_bps": 20e6, "propagation_s": 0.003,
               "jitter_s": 0.002},
    "trace": {"schedule": [[0.0, 50e6], [0.05, 0.0], [0.08, 2e6],
                           [0.2, 80e6]], "propagation_s": 0.001},
    "markov": {"states_bps": [100e6, 20e6, 2e6],
               "transition": [[0.9, 0.08, 0.02], [0.3, 0.55, 0.15],
                              [0.1, 0.3, 0.6]], "dwell_s": 0.02,
               "jitter_s": 0.001},
    "lossy": {"bandwidth_bps": 40e6, "loss_p": 0.3, "rto_s": 0.01},
    "jitter": {"bandwidth_bps": 40e6, "jitter_s": 0.004,
               "propagation_s": 0.004},
}


def test_link_kinds_match_the_reference():
    assert set(t_net.LINK_KINDS) == set(j_net.LINK_KINDS) == set(LINK_PARAMS)
    with pytest.raises(KeyError, match="unknown link kind"):
        t_net.make_link("nope")


def _sends(link, rng_seed, n=60):
    rng = np.random.default_rng(rng_seed)
    ts = np.cumsum(rng.exponential(0.004, n))
    sizes = rng.integers(1, 60_000, n)
    return [tuple((tr.start, tr.tx_done, tr.arrival, tr.payload_bytes))
            for tr in (link.send(float(t), int(b))
                       for t, b in zip(ts, sizes))]


@pytest.mark.parametrize("kind", sorted(LINK_PARAMS))
@pytest.mark.parametrize("seed", [0, 7, 13])
def test_every_link_kind_replays_the_reference_bitwise(kind, seed):
    t = t_net.make_link(kind, seed=seed, **LINK_PARAMS[kind])
    j = j_net.make_link(kind, seed=seed, **LINK_PARAMS[kind])
    first = _sends(t, seed)
    assert first == _sends(j, seed)
    assert t.tx_time(1234) == j.tx_time(1234)
    t.reset()
    j.reset()
    assert _sends(t, seed) == first == _sends(j, seed)


def test_trace_and_markov_bandwidth_queries_equal_reference():
    t = t_net.make_link("markov", seed=3, **LINK_PARAMS["markov"])
    j = j_net.make_link("markov", seed=3, **LINK_PARAMS["markov"])
    qs = [0.0, 0.5, 0.013, 0.2, 0.0199, 1.7]
    assert [t.bandwidth_at(q) for q in qs] == [j.bandwidth_at(q) for q in qs]
    t = t_net.make_link("trace", **LINK_PARAMS["trace"])
    j = j_net.make_link("trace", **LINK_PARAMS["trace"])
    assert [t.bandwidth_at(q) for q in qs] == [j.bandwidth_at(q) for q in qs]
    assert t.nominal_bps == j.nominal_bps


@pytest.mark.parametrize("bad", [
    ("trace", {"schedule": [[0.1, 1e6]]}),
    ("trace", {"schedule": [[0.0, 1e6], [1.0, 0.0]]}),
    ("markov", {"states_bps": [1e6, 0.0], "transition": [[1, 0], [0, 1]]}),
    ("markov", {"states_bps": [1e6], "transition": [[0.5]]}),
    ("lossy", {"bandwidth_bps": 1e6, "loss_p": 1.0}),
])
def test_link_validation_matches_reference(bad):
    kind, params = bad
    with pytest.raises(ValueError) as te:
        t_net.make_link(kind, **params)
    with pytest.raises(ValueError) as je:
        j_net.make_link(kind, **params)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------- break-even
@pytest.mark.parametrize("cfg", [(400, 3, 4, 0.1), (84, 3, 4, 2e-4),
                                 (256, 2, 16, 0.05), (85, 3, 4, 1e-3)])
def test_crossover_equals_reference(cfg):
    ref = _load_reference_benchmark("break_even")
    assert t_be.crossover_mbps(t_lat.SplitConfig(*cfg)) \
        == ref.crossover_mbps(j_lat.SplitConfig(*cfg))


def test_break_even_run_rows_equal_reference(capsys):
    ref = _load_reference_benchmark("break_even")
    got = t_be.run()
    want = ref.run()
    assert got == want
    assert got[0]["config"] == "paper" and round(got[0]["pred"], 1) == 50.4
    out = capsys.readouterr().out
    # the pod-boundary lines print the same numbers in both packages
    pod = [line for line in out.splitlines() if "Gb/s (DCN" in line]
    assert len(pod) == 4 and pod[:2] == pod[2:]
