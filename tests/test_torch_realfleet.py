"""The port's real multi-process fleet (``repro_torch.serving.realfleet``)
against the reference's.

Three layers, cheap to expensive:

* framing: the port's ``pack_payload`` writes the reference's bytes for
  every wire codec's payload (the port's codec on a torch tensor, the
  reference's on the same numpy floats), unpacks bitwise, and frames
  round-trip over a real socket pair;
* threaded ``WorkerServer`` + ``FleetClient`` (no process spawn): a port
  client against a reference worker and the reverse give equal answers;
  continuous batching admits during service, a timeout surfaces instead of
  hanging, a crash mid-request re-routes, an exception answers MSG_ERR,
  shutdown drains, ``run_load`` runs open loop; ``TokenBucket`` on an
  injected clock gives the reference's waits bit for bit;
* spawned processes, through ``python -m repro_torch.deploy --real-fleet
  --device cpu``: a 2-worker fleet serves actions bitwise equal to
  in-process serving through every router and after a worker is killed,
  with no leaked worker.

The reference's wall-clock shaping test is not mirrored: the injected-clock
bucket test covers the bucket.
"""
import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core import wire as j_wire
from repro.serving import realfleet as j_rf
from repro_torch import deploy as t_deploy
from repro_torch.core import wire as t_wire
from repro_torch.serving import realfleet as t_rf
from repro_torch.serving.realfleet import (MSG_REQ, MSG_RESP, MSG_SHUTDOWN,
                                           FleetClient, FleetError,
                                           FleetTimeout, RealFleet,
                                           ShapingConfig, TokenBucket,
                                           WorkerServer, _recv_frame,
                                           _send_frame, pack_payload,
                                           run_load, unpack_payload)

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)


# ------------------------------------------------------------------ framing
def _bits(v):
    """Raw bytes of a payload tensor: numpy array or (bf16) torch tensor."""
    if isinstance(v, torch.Tensor):
        v = v.contiguous()
        return (v.view(torch.int16) if v.dtype == torch.bfloat16
                else v).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


@pytest.mark.parametrize("name", sorted(t_wire.CODECS))
def test_pack_bytes_equal_reference_per_codec(name):
    """One codec's payload of equal floats: the port packs the reference's
    bytes (from torch tensors and from the reference's numpy payload), and
    unpacks each tensor bitwise with its dtype and shape."""
    x = np.random.default_rng(0).random((1, 5, 5, 4), dtype=np.float32)
    jp = {k: np.asarray(v)
          for k, v in j_wire.CODECS[name].encode(jnp.asarray(x)).items()}
    tp = t_wire.CODECS[name].encode(torch.from_numpy(x))
    want = j_rf.pack_payload(jp)
    assert t_rf.pack_payload(tp) == want
    assert t_rf.pack_payload(jp) == want
    back = unpack_payload(want)
    assert set(back) == set(tp)
    for k, v in tp.items():
        assert tuple(back[k].shape) == tuple(v.shape)
        assert _bits(back[k]) == _bits(v)
        if name != "bf16":
            assert back[k].dtype == jp[k].dtype
    if name == "bf16":
        assert back["data"].dtype == torch.bfloat16
    # and the reference unpacks the port's bytes to its own payload
    for k, v in j_rf.unpack_payload(t_rf.pack_payload(tp)).items():
        assert v.dtype == jp[k].dtype and v.tobytes() == jp[k].tobytes()


def test_pack_moves_a_batch_of_torch_payloads_to_numpy():
    p = t_wire.CODECS["uint8"].encode_batch(
        torch.from_numpy(np.random.default_rng(1).random((3, 2, 2, 4),
                                                         dtype=np.float32)))
    back = unpack_payload(pack_payload(p))
    for k, v in p.items():
        assert isinstance(back[k], np.ndarray)
        np.testing.assert_array_equal(back[k], v.numpy())


def test_frame_roundtrip_over_socket():
    a, b = socket.socketpair()
    try:
        _send_frame(a, MSG_REQ, b"\x00\x01payload")
        mtype, body = _recv_frame(b)
        assert mtype == MSG_REQ and body == b"\x00\x01payload"
        _send_frame(b, MSG_RESP)               # empty body is legal
        assert _recv_frame(a) == (MSG_RESP, b"")
        a.close()
        assert _recv_frame(b) == (None, None)  # clean EOF, not an exception
    finally:
        a.close()
        b.close()


# ------------------------------------------- threaded worker + front door
def _payload(value, n=2):
    return {"data": np.full((n,), float(value), np.float32)}


def _uint8_payload(seed):
    x = np.random.default_rng(seed).random((1, 3, 3, 4), dtype=np.float32)
    return t_wire.CODECS["uint8"].encode(torch.from_numpy(x))


def _decode_double(stacked):
    """A torch server half: the uint8 codec's batched decode, doubled."""
    batch = {k: torch.as_tensor(v) for k, v in stacked.items()}
    return t_wire.CODECS["uint8"].decode_batch(batch).reshape(
        batch["data"].shape[0], -1) * 2.0


def _decode_double_np(stacked):
    """The same function in numpy, as a reference worker would run it."""
    d = stacked["data"].astype(np.float32)
    scale = stacked["scale"].reshape((-1,) + (1,) * (d.ndim - 1))
    zero = stacked["zero"].reshape((-1,) + (1,) * (d.ndim - 1))
    return (d * scale + zero).reshape(d.shape[0], -1) * np.float32(2.0)


@pytest.mark.parametrize("client_pkg,worker_pkg",
                         [("port", "reference"), ("reference", "port")])
def test_protocol_parity_across_packages(client_pkg, worker_pkg):
    """A port client against a reference worker, and the reverse, in
    threads: the answers equal those of a worker of the client's own
    package."""
    mods = {"port": t_rf, "reference": j_rf}
    fns = {"port": _decode_double, "reference": _decode_double_np}
    payloads = [_uint8_payload(s) for s in range(3)]
    answers = {}
    for wpkg in (worker_pkg, client_pkg):
        ws = mods[wpkg].WorkerServer(fns[wpkg], max_batch=4)
        fc = mods[client_pkg].FleetClient([ws.start()], timeout_s=10.0,
                                          retries=0)
        try:
            body = [p if client_pkg == "port"
                    else {k: v.numpy() for k, v in p.items()}
                    for p in payloads]
            answers[wpkg] = [fc.request(b, client=i)
                             for i, b in enumerate(body)]
        finally:
            fc.shutdown()
            ws.join(5.0)
    for got, want in zip(answers[worker_pkg], answers[client_pkg]):
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bf16_payload_reaches_a_port_worker_as_a_tensor():
    seen = {}

    def fn(stacked):
        seen["dtype"] = stacked["data"].dtype
        return stacked["data"].float() * 2.0

    ws = WorkerServer(fn, max_batch=2)
    fc = FleetClient([ws.start()], timeout_s=10.0, retries=0)
    x = torch.linspace(-1, 1, 8).reshape(1, 8)
    out = fc.request(t_wire.CODECS["bf16"].encode(x))
    fc.shutdown()
    ws.join(5.0)
    assert seen["dtype"] == torch.bfloat16
    np.testing.assert_array_equal(
        out, (x.to(torch.bfloat16).float() * 2.0).numpy())


def test_continuous_batching_admits_during_service():
    """Requests arriving while a micro-batch is in service form the NEXT
    batch: the service time is the batching window, no max_wait hold."""
    in_service = threading.Event()
    release = threading.Event()

    def slow_double(stacked):
        in_service.set()
        release.wait(5.0)
        return torch.as_tensor(stacked["data"]) * 2.0

    ws = WorkerServer(slow_double, max_batch=8)
    addr = ws.start()
    fc = FleetClient([addr], timeout_s=10.0, retries=0)
    results = {}

    def issue(i):
        results[i] = fc.request(_payload(i))

    threads = [threading.Thread(target=issue, args=(0,))]
    threads[0].start()
    assert in_service.wait(5.0)        # batch [0] is on the device
    for i in (1, 2, 3):                # these arrive during its service
        t = threading.Thread(target=issue, args=(i,))
        t.start()
        threads.append(t)
    deadline = time.monotonic() + 5.0
    while ws._q.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)               # all three queued at the worker
    release.set()
    for t in threads:
        t.join(10.0)
        assert not t.is_alive()
    for i in range(4):
        np.testing.assert_array_equal(results[i],
                                      np.full((2,), 2.0 * i, np.float32))
    assert ws.batch_sizes[0] == 1      # lone first request never held
    assert ws.batch_sizes[1] == 3      # the backlog launched as ONE batch
    assert fc.stats["max_served_batch"] == 3
    fc.shutdown()
    ws.join(5.0)


def test_timeout_surfaces_instead_of_hanging():
    def stuck(stacked):
        time.sleep(3.0)
        return stacked["data"]

    ws = WorkerServer(stuck, max_batch=2)
    addr = ws.start()
    fc = FleetClient([addr], timeout_s=0.15, retries=0)
    t0 = time.monotonic()
    with pytest.raises(FleetTimeout):
        fc.request(_payload(0))
    assert time.monotonic() - t0 < 1.5
    assert fc.stats["timeouts"] == 1
    ws.stop()
    fc.shutdown(wait_pending_s=0.1)


def test_error_in_the_batch_answers_every_request():
    """An exception in the server half answers each request of its batch
    with MSG_ERR: the client raises at once, it never hangs."""
    def broken(stacked):
        raise RuntimeError("device fault")

    ws = WorkerServer(broken, max_batch=2)
    fc = FleetClient([ws.start()], timeout_s=10.0, retries=0)
    t0 = time.monotonic()
    with pytest.raises(FleetTimeout) as exc:
        fc.request(_payload(0))
    assert time.monotonic() - t0 < 5.0
    assert isinstance(exc.value.__cause__, FleetError)
    assert "RuntimeError: device fault" in str(exc.value.__cause__)
    assert fc.stats["errors"] == 1
    fc.shutdown()
    ws.join(5.0)


def test_crash_mid_request_reroutes_retry():
    """A worker dying mid-request fails the pending request at once
    (connection EOF, not a timeout) and the retry re-routes to a live
    worker."""
    crashing = {}

    def crash(stacked):
        crashing["ws"].stop()          # drops every connection, no response
        raise RuntimeError("worker crashed mid-batch")

    ws0 = WorkerServer(crash, max_batch=2)
    crashing["ws"] = ws0
    ws1 = WorkerServer(lambda s: torch.as_tensor(s["data"]) + 1.0,
                       max_batch=2)
    a0, a1 = ws0.start(), ws1.start()
    fc = FleetClient([a0, a1], router="round_robin", timeout_s=5.0,
                     retries=2)
    out = fc.request(_payload(0))      # seq 0 -> server 0 -> crash -> retry
    np.testing.assert_array_equal(out, np.ones((2,), np.float32))
    assert fc.stats["retries"] >= 1
    assert fc.stats["per_server"][1] == 1
    assert not fc.conns[0].alive       # marked dead for later requests
    out2 = fc.request(_payload(1))     # routes straight to the live worker
    np.testing.assert_array_equal(out2, np.full((2,), 2.0, np.float32))
    fc.shutdown()
    ws1.join(5.0)


def test_graceful_shutdown_drains_queued_requests():
    """Every request received before SHUTDOWN is served and answered
    before the worker exits."""
    def slowish(stacked):
        time.sleep(0.03)
        return stacked["data"]

    ws = WorkerServer(slowish, max_batch=2)
    addr = ws.start()
    s = socket.create_connection(addr)
    try:
        body = pack_payload(_payload(7, n=3))
        for rid in range(3):
            _send_frame(s, MSG_REQ, struct.pack("!I", rid) + body)
        _send_frame(s, MSG_SHUTDOWN)
        got = set()
        for _ in range(3):
            mtype, b = _recv_frame(s)
            assert mtype == MSG_RESP
            rid, _bsz = struct.unpack_from("!IH", b)
            got.add(rid)
            np.testing.assert_array_equal(
                unpack_payload(b[6:])["action"],
                np.full((3,), 7.0, np.float32))
        assert got == {0, 1, 2}
    finally:
        s.close()
    ws.join(5.0)
    assert ws.n_served == 3


def test_run_load_open_loop():
    ws = WorkerServer(lambda s: torch.as_tensor(s["data"]) * 2.0,
                      max_batch=4)
    addr = ws.start()
    fc = FleetClient([addr], timeout_s=5.0)
    rep = run_load(fc, _payload(1), n_clients=2, rate_hz=20.0,
                   duration_s=0.5)
    assert rep.n_requests == 20        # 2 clients x 20 Hz x 0.5 s
    assert rep.n_failures == 0
    assert 0.0 < rep.p50() <= rep.p95()
    fc.shutdown()
    ws.join(5.0)


# ------------------------------------------------------- ingress shaping
def test_token_bucket_equals_reference_on_an_injected_clock():
    """The same (time, bytes) sequence gives the reference's waits bit for
    bit, and the GCRA arithmetic the reference's test pins."""
    rng = np.random.default_rng(3)
    steps = [(float(t), int(n)) for t, n in zip(
        np.cumsum(rng.exponential(0.004, 200)),
        rng.integers(100, 20_000, 200))]
    steps += [(steps[-1][0], 1_000)] * 50      # a frozen clock: debt grows
    waits = {}
    for name, mod in (("port", t_rf), ("reference", j_rf)):
        now = [0.0]
        tb = mod.TokenBucket(rate_bps=8e6, burst_bytes=10_000,
                             clock=lambda: now[0])
        out = []
        for t, n in steps:
            now[0] = t
            out.append(tb.reserve(n))
        waits[name] = out
    assert waits["port"] == waits["reference"]
    assert any(w > 0.0 for w in waits["port"])

    now = [0.0]
    tb = TokenBucket(rate_bps=8e6, burst_bytes=10_000,  # 1 MB/s, 10 kB burst
                     clock=lambda: now[0])
    assert tb.reserve(10_000) == 0.0          # the burst rides free
    assert tb.reserve(10_000) == pytest.approx(0.01)   # 10 kB at 1 MB/s
    now[0] = 1.0                              # bucket refills while idle
    assert tb.reserve(10_000) == 0.0


def test_shaping_config_roundtrip_and_dict_equals_reference():
    cfg = ShapingConfig(rate_mbps=2.0, burst_bytes=4096)
    assert ShapingConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == j_rf.ShapingConfig(rate_mbps=2.0,
                                               burst_bytes=4096).to_dict()
    assert ShapingConfig.from_dict(j_rf.ShapingConfig(
        rate_mbps=10.0).to_dict()) == ShapingConfig(rate_mbps=10.0)
    assert isinstance(cfg.bucket(), TokenBucket)
    with pytest.raises(ValueError):
        ShapingConfig(rate_mbps=0.0)
    with pytest.raises(ValueError):
        ShapingConfig(rate_mbps=1.0, burst_bytes=0)
    with pytest.raises(ValueError, match="version"):
        ShapingConfig.from_dict(dict(cfg.to_dict(), version=99))


# ------------------------------------------- the fleet, without spawning
def _small_config(**kw):
    return t_deploy.DeploymentConfig.standard(
        k=4, c_in=4, h=24, backend="xla", **kw)


def test_deployment_fleet_caps_admission_at_the_measured_batch():
    from repro_torch.serving.server import BatchServiceModel
    dep = t_deploy.Deployment.build(_small_config(max_batch=8, n_servers=3,
                                                  router="least_loaded"),
                                    device="cpu")
    params = dep.init(torch.Generator().manual_seed(0))
    model = BatchServiceModel(((1, 1e-3), (2, 1.5e-3)))
    fl = dep.fleet(params, service_model=model, start=False)
    assert fl.max_batch == 2 and fl.processes == []
    assert (fl.n_servers, fl.router, fl.device) == (3, "least_loaded", "cpu")
    assert dep.fleet(params, start=False).max_batch == 8
    assert dep.fleet(params, max_batch=4, service_model=model,
                     start=False).max_batch == 2
    # the parameters cross the process boundary as numpy arrays
    leaf = fl.params["server"]["proj"]["kernel"]
    assert isinstance(leaf, np.ndarray)
    np.testing.assert_array_equal(leaf,
                                  params["server"]["proj"]["kernel"].numpy())
    assert fl.stats == {}
    with pytest.raises(RuntimeError, match="not started"):
        fl.request(_payload(0))


def test_real_fleet_refuses_fork_on_a_cuda_device():
    manifest = _small_config().to_dict()
    with pytest.raises(ValueError, match="spawn"):
        RealFleet(manifest, {}, device="cuda", mp_context="fork")
    RealFleet(manifest, {}, device="cpu", mp_context="fork")   # allowed
    assert RealFleet(manifest, {}).device == "cuda"


# ----------------------------------------------------- spawned processes
def test_real_fleet_two_servers_bitwise_and_crash(tmp_path, capsys):
    """The acceptance test, through ``python -m repro_torch.deploy
    --real-fleet --device cpu``: a manifest-built 2-worker fleet serves
    socket actions bitwise equal to in-process serving through every
    registered router, re-routes around a killed worker and stays bitwise
    equal, and shuts down without leaking a process (the check raises on
    any of these)."""
    t_deploy.main(["--real-fleet", "--device", "cpu", "--x", "24",
                   "--c-in", "4", "--backend", "xla", "--n-servers", "2",
                   "--max-batch", "2", "--out", str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert ("2 worker(s) on cpu served 8 requests over sockets through "
            "each of round_robin, client_affinity, least_loaded") in out
    assert "actions bitwise equal to in-process serving" in out
    after = next(l for l in out.splitlines() if "killed;" in l)
    # every request reached the live worker (one may first have been sent
    # to the dead one before its socket closed, then retried)
    assert "8 requests re-routed (per-server [" in after
    assert int(after.split("per-server [")[1].split("]")[0]
               .split(", ")[1]) == 8
    assert "clean shutdown, no leaked workers" in out
