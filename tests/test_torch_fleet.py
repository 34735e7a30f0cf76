"""The port's queue and fleet simulators and device zoo against the
reference.

``QueueSim``, ``BatchQueueSim`` and ``FleetQueueSim`` (every router, both
engines, 1/2/4 servers, homogeneous and zoo fleets) are fed the same
measured-style t(B) points and must give latencies ``np.array_equal`` to
the reference's; ``max_clients`` and ``min_servers`` must agree exactly.
At ``n_servers=1`` the port's fleet reduces bitwise to its own
``BatchQueueSim``.  Kept small: at most 32 clients, horizons of at most
2 s.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import fleet as j_fleet
from repro.serving import netsim as j_net
from repro.serving import profiles as j_prof
from repro.serving import server as j_srv
from repro_torch.serving import fleet as t_fleet
from repro_torch.serving import netsim as t_net
from repro_torch.serving import profiles as t_prof
from repro_torch.serving import server as t_srv

POINTS = ((1, 0.008), (2, 0.009), (4, 0.011), (8, 0.015))
# a curve like a measured one: not monotone between samples
NOISY = ((1, 0.0030), (2, 0.0052), (4, 0.0047), (8, 0.0081))


def _pair(cls_name, *, points=POINTS, mbps=100.0, payload=10_000,
          horizon=1.5, **kw):
    """The same simulator built in both packages: (port, reference)."""
    out = []
    for srv, net in ((t_srv, t_net), (j_srv, j_net)):
        model = srv.BatchServiceModel(points)
        common = dict(service_time_s=model(1), uplink=net.shaped(mbps),
                      payload_bytes=payload, horizon_s=horizon)
        if cls_name == "QueueSim":
            out.append(srv.QueueSim(**common, **kw))
        elif cls_name == "BatchQueueSim":
            out.append(srv.BatchQueueSim(**common, service_model=model, **kw))
        else:
            fl = t_fleet if srv is t_srv else j_fleet
            out.append(fl.FleetQueueSim(**common, service_model=model, **kw))
    return out


@pytest.mark.parametrize("n", [1, 5, 17, 32])
@pytest.mark.parametrize("mbps", [10.0, 100.0])
def test_fifo_queue_equals_reference(n, mbps):
    t, j = _pair("QueueSim", mbps=mbps)
    assert np.array_equal(t.latencies(n), j.latencies(n))
    assert t.p95(n) == j.p95(n)


@pytest.mark.parametrize("points", [POINTS, NOISY], ids=["smooth", "noisy"])
@pytest.mark.parametrize("max_batch,max_wait_s",
                         [(1, 0.0), (4, 0.0), (8, 0.0), (8, 0.01)])
@pytest.mark.parametrize("n", [3, 16, 32])
def test_batch_queue_equals_reference(points, max_batch, max_wait_s, n):
    t, j = _pair("BatchQueueSim", points=points, max_batch=max_batch,
                 max_wait_s=max_wait_s)
    assert np.array_equal(t.latencies(n), j.latencies(n))


def test_service_model_extrapolation_equals_reference():
    for oor in ("extrapolate", "clamp"):
        t = t_srv.BatchServiceModel(NOISY, out_of_range=oor)
        j = j_srv.BatchServiceModel(NOISY, out_of_range=oor)
        with pytest.warns(RuntimeWarning):
            t(12)
        with pytest.warns(RuntimeWarning):
            j(12)
        assert [t(b) for b in range(1, 20)] == [j(b) for b in range(1, 20)]


@pytest.mark.parametrize("cls_name,kw", [
    ("QueueSim", {}),
    ("BatchQueueSim", {"max_batch": 8}),
    ("BatchQueueSim", {"max_batch": 8, "max_wait_s": 0.02}),
])
def test_max_clients_equals_reference(cls_name, kw):
    t, j = _pair(cls_name, points=((1, 0.02), (2, 0.03), (4, 0.05),
                                   (8, 0.09)), horizon=1.0, **kw)
    assert t.max_clients(n_max=32) == j.max_clients(n_max=32)
    assert t._zero_scan_limit(0.1) == j._zero_scan_limit(0.1)


@pytest.mark.parametrize("router", ["round_robin", "least_loaded",
                                    "client_affinity"])
@pytest.mark.parametrize("n_servers", [1, 2, 4])
@pytest.mark.parametrize("max_wait_s", [0.0, 0.005])
def test_fleet_trace_equals_reference(router, n_servers, max_wait_s):
    t, j = _pair("FleetQueueSim", n_servers=n_servers, router=router,
                 max_batch=4, max_wait_s=max_wait_s, payload=2_000)
    for n in (7, 32):
        tt, jt = t.trace(n), j.trace(n)
        assert tt.dtype == jt.dtype and np.array_equal(tt, jt)
        assert np.array_equal(t.latencies(n), j.latencies(n))


@pytest.mark.parametrize("router", ["round_robin", "least_loaded",
                                    "client_affinity"])
def test_fleet_scan_engine_equals_reference_heap(router):
    t, j = _pair("FleetQueueSim", n_servers=3, router=router, max_batch=4,
                 engine="scan", payload=2_000)
    j.engine = "heap"
    assert np.array_equal(t.trace(20), j.trace(20))


@pytest.mark.parametrize("router", ["round_robin", "least_loaded",
                                    "client_affinity"])
@pytest.mark.parametrize("max_wait_s", [0.0, 0.01])
def test_fleet_of_one_reduces_to_batch_queue(router, max_wait_s):
    fleet, _ = _pair("FleetQueueSim", n_servers=1, router=router,
                     max_batch=8, max_wait_s=max_wait_s)
    bat, _ = _pair("BatchQueueSim", max_batch=8, max_wait_s=max_wait_s)
    for n in (1, 9, 32):
        assert np.array_equal(fleet.latencies(n), bat.latencies(n))


def test_routers_equal_reference():
    assert t_fleet.router_names() == j_fleet.router_names()
    assert [t_fleet._mix32(c) for c in range(200)] == \
        [j_fleet._mix32(c) for c in range(200)]
    q, free = [2, 0, 1, 0], [0.5, 0.1, 0.0, 0.3]
    for name in t_fleet.router_names():
        for seq in range(6):
            assert t_fleet.get_router(name)(seq * 3, seq, 0.2, q, free) == \
                j_fleet.get_router(name)(seq * 3, seq, 0.2, q, free)
    with pytest.raises(ValueError, match="unknown router"):
        t_fleet.get_router("nope")


def test_zoo_fleet_and_sizing_equal_reference():
    def sims(prof, fl, srv, net):
        models = prof.zoo(("jetson_nano", "pi_4b", "pi_zero_2w"), 3)
        return fl.FleetQueueSim(
            service_time_s=models[0](1), uplink=net.shaped(100.0),
            payload_bytes=5_000, horizon_s=1.0, max_batch=8,
            n_servers=3, router="client_affinity", service_models=models)
    t = sims(t_prof, t_fleet, t_srv, t_net)
    j = sims(j_prof, j_fleet, j_srv, j_net)
    assert np.array_equal(t.trace(24), j.trace(24))
    assert t.max_clients(n_max=32) == j.max_clients(n_max=32)
    assert t.min_servers(24, n_servers_max=4) == \
        j.min_servers(24, n_servers_max=4)
    assert np.array_equal(t.with_servers(5, "least_loaded").latencies(16),
                          j.with_servers(5, "least_loaded").latencies(16))


def test_fleet_max_clients_equals_reference():
    t, j = _pair("FleetQueueSim", points=((1, 0.02), (2, 0.03), (4, 0.05),
                                          (8, 0.09)), horizon=1.0,
                 n_servers=2, router="least_loaded", max_batch=8)
    assert t.max_clients(n_max=32) == j.max_clients(n_max=32)
    assert t.min_servers(32, n_servers_max=4) == \
        j.min_servers(32, n_servers_max=4)


def test_device_profiles_equal_reference():
    assert t_prof.profile_names() == j_prof.profile_names()
    for name in t_prof.profile_names():
        tp, jp = t_prof.get_profile(name), j_prof.get_profile(name)
        assert (tp.name, tp.service_points, tp.encode_s, tp.notes) == \
            (jp.name, jp.service_points, jp.encode_s, jp.notes)
    tz = t_prof.zoo(("pi_4b", "workstation"), 5)
    jz = j_prof.zoo(("pi_4b", "workstation"), 5)
    assert [[m(b) for b in range(1, 9)] for m in tz] == \
        [[m(b) for b in range(1, 9)] for m in jz]
    with pytest.raises(KeyError, match="unknown device profile"):
        t_prof.get_profile("nope")
    with pytest.raises(ValueError):
        t_prof.zoo((), 2)
