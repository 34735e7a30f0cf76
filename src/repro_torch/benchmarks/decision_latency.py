"""Paper Table 5 on the card: end-to-end decision latency under bandwidth
shaping (port of the reference's ``benchmarks/decision_latency.py``).

Median over N decisions of (observation available -> action received),
server-only (full RGBA frame transmitted, Full-CNN + head on the server)
against split-policy (MiniConv on the edge, K=4 uint8 features
transmitted).  The stage times are measured on ``--device`` (``cuda`` by
default) with the real networks, on the host clock around a device
synchronize; the link is the deterministic token-bucket shaper.

The split pipeline (encoder, plan, codec, serving halves, payload
accounting) is built from ONE :class:`repro_torch.deploy.DeploymentConfig`
by ``Deployment.build``; ``--manifest`` loads that config from the JSON
file ``python -m repro_torch.deploy`` writes.

``--clients N`` also reports the p95 decision latency of N clients sharing
one split-policy server, FIFO against micro-batching (the batch-aware
queue simulation fed by the measured t(B) curve), and the fleet's p95 when
the manifest sets ``n_servers > 1``.  ``--real-fleet`` also spawns the
manifest's fleet on localhost (``repro_torch.serving.realfleet``, workers
on ``--device``) and reports its measured p95 under the same open-loop
load beside the loopback sim's.  Nothing is written to disk:

    python -m repro_torch.benchmarks.decision_latency
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.device import DeviceLike
from repro_torch.rl.networks import (full_cnn_apply, full_cnn_init,
                                     mlp_apply, mlp_init)
from repro_torch.serving.client import DecisionLoop, EdgeClient
from repro_torch.serving.netsim import shaped
from repro_torch.serving.server import (BatchingPolicyServer, BatchQueueSim,
                                        PolicyServer, QueueSim)

X_SIZE = 84           # paper's task-scale observation (84x84, 3 frames)
C_IN = 12             # RGBA x 3 stacked frames at the upload boundary


@dataclasses.dataclass(frozen=True)
class ServingSetup:
    """The served halves and payload accounting shared by the serving
    benchmarks, all resolved from ONE ``Deployment.build``."""

    deployment: Deployment
    edge_fn: object               # obs -> single-request payload
    split_server_fn: object       # payload -> action
    split_server_batch_fn: object  # stacked micro-batch payload -> actions
    mono_server_fn: object        # obs -> action
    obs: object
    wire_bytes: int
    frame_bytes: int
    params: object = None         # the deployment's parameters


def standard_config(*, k: int = 4, backend: str = "xla",
                    max_batch: int = 8) -> DeploymentConfig:
    """The benchmark's canonical deployment: the paper's K-channel encoder
    at task scale.  ``xla`` (eager PyTorch) is the default, as in the
    reference; pass ``backend="fused"`` (or a tuned manifest) for K1."""
    return DeploymentConfig.standard(k=k, c_in=C_IN, h=X_SIZE,
                                     backend=backend, max_batch=max_batch)


def build(*, k: int = 4, seed: int = 0,
          config: DeploymentConfig | None = None,
          device: DeviceLike = None) -> ServingSetup:
    """Build the split deployment, the Full-CNN server-only baseline and a
    policy head on ``device`` (``cuda`` by default), each from its own
    ``torch.Generator`` seeded from ``seed``."""
    cfg = config or standard_config(k=k)
    dep = Deployment.build(cfg, device=device)
    dev = dep.device
    c_in = cfg.spec.layers[0].c_in      # manifests may deviate from C_IN
    params = dep.init(torch.Generator().manual_seed(seed))
    cnn = full_cnn_init(torch.Generator().manual_seed(seed + 1), c_in,
                        h=cfg.in_h, w=cfg.in_w, device=dev)
    head = mlp_init(torch.Generator().manual_seed(seed + 2),
                    [cfg.head_dim, 256, 3], device=dev)

    def head_fn(z):
        return mlp_apply(head, z)

    edge_fn = dep.edge_fn(params)
    split_server_fn = dep.server_fn(params, head=head_fn)
    split_server_batch_fn = dep.server_batch_fn(params, head=head_fn)

    def mono_server_fn(obs):
        with torch.inference_mode():
            return mlp_apply(head, full_cnn_apply(cnn, obs))

    obs = torch.rand((1, cfg.in_h, cfg.in_w, c_in),
                     generator=torch.Generator().manual_seed(seed + 3)
                     ).to(dev)
    return ServingSetup(dep, edge_fn, split_server_fn, split_server_batch_fn,
                        mono_server_fn, obs, dep.wire_bytes, dep.frame_bytes,
                        params)


def run(bandwidths=(10, 25, 50, 100), *, n_decisions: int = 1000,
        k: int = 4, config: DeploymentConfig | None = None,
        device: DeviceLike = None, setup: ServingSetup | None = None):
    """Table 5: the stage times measured on the device (host clock around
    a synchronize), then the median decision latency of each pipeline at
    each bandwidth (Mb/s)."""
    setup = setup or build(k=k, config=config, device=device)
    wire_bytes, frame_bytes = setup.wire_bytes, setup.frame_bytes
    client = EdgeClient(encode_fn=setup.edge_fn, wire_bytes=wire_bytes)
    j = client.measure(setup.obs)
    payload = setup.edge_fn(setup.obs)
    s_split = PolicyServer(serve_fn=setup.split_server_fn).measure(payload)
    s_mono = PolicyServer(serve_fn=setup.mono_server_fn).measure(setup.obs)
    print(f"  stages: edge={j*1e3:.4f}ms split_srv={s_split*1e3:.4f}ms "
          f"mono_srv={s_mono*1e3:.4f}ms wire={wire_bytes}B "
          f"frame={frame_bytes}B")

    rows = []
    for mbps in bandwidths:
        so = DecisionLoop(link=shaped(mbps), server_time_s=s_mono,
                          split=False, payload_bytes=frame_bytes)
        sp = DecisionLoop(link=shaped(mbps), server_time_s=s_split,
                          split=True, edge_time_s=j,
                          payload_bytes=wire_bytes)
        row = {"mbps": mbps,
               "server_only_ms": so.median_latency(n_decisions) * 1e3,
               "split_ms": sp.median_latency(n_decisions) * 1e3}
        rows.append(row)
        print(f"  {mbps:>5} Mb/s  server-only {row['server_only_ms']:9.4f} "
              f"ms   split {row['split_ms']:9.4f} ms")
    return rows


def measure_service_curve(setup: ServingSetup, *, max_batch: int = 8,
                          max_wait_s: float = 0.0, iters: int = 10):
    """Measure the batched split server's t(B) curve on the setup's device.

    Shared by this benchmark and ``benchmarks.scalability`` so the two
    FIFO-against-batched reports sample the curve the same way.  Returns
    ({batch: seconds}, BatchServiceModel); the times are Python floats.
    """
    payload = setup.edge_fn(setup.obs)
    bsrv = BatchingPolicyServer(serve_batch_fn=setup.split_server_batch_fn,
                                max_batch=max_batch, max_wait_s=max_wait_s)
    times = bsrv.measure(payload, batch_sizes=tuple(
        b for b in (1, 2, 4, 8, 16) if b <= max_batch), iters=iters)
    model = bsrv.service_model()
    curve = " ".join(f"t({b})={t*1e3:.4f}ms"
                     for b, t in sorted(times.items()))
    print(f"  batched service curve: {curve}")
    return times, model


def run_queue(*, n_clients: int = 8, mbps: float = 100.0, k: int = 4,
              max_batch: int = 8, max_wait_ms: float = 0.0,
              rate_hz: float = 10.0, setup: ServingSetup | None = None,
              device: DeviceLike = None, model=None,
              real_fleet: bool = False):
    """p95 decision latency at N clients: FIFO server against
    micro-batching, both on the MEASURED t(B) curve (``model``, measured
    here when not given).  When the manifest sets ``n_servers > 1`` the
    sharded fleet's p95 is reported too: the same curve on every server,
    routed by the configured policy.  ``real_fleet=True`` adds
    :func:`run_real_fleet`'s measured p95 of the spawned fleet."""
    setup = setup or build(k=k, device=device)
    if model is None:
        times, model = measure_service_curve(setup, max_batch=max_batch,
                                             max_wait_s=max_wait_ms / 1e3)
    else:
        times = dict(model.points)
    common = dict(service_time_s=model(1), uplink=shaped(mbps),
                  payload_bytes=setup.wire_bytes, rate_hz=rate_hz,
                  horizon_s=5.0)
    fifo = QueueSim(**common)
    bat = BatchQueueSim(**common, max_batch=max_batch,
                        max_wait_s=max_wait_ms / 1e3, service_model=model)
    row = {"n_clients": n_clients,
           "service_ms": {b: t * 1e3 for b, t in times.items()},
           "fifo_p95_ms": fifo.p95(n_clients) * 1e3,
           "batched_p95_ms": bat.p95(n_clients) * 1e3}
    print(f"  N={n_clients} @ {rate_hz:.0f}Hz: p95 FIFO "
          f"{row['fifo_p95_ms']:.4f} ms vs micro-batched "
          f"{row['batched_p95_ms']:.4f} ms "
          f"(max_batch={max_batch}, max_wait={max_wait_ms:.0f}ms)")
    cfg = setup.deployment.config
    if cfg.n_servers > 1:
        # same batching policy as the FIFO/batched rows above (and as the
        # measured t(B) curve), not the manifest's: the three p95s must
        # be comparable
        fleet = setup.deployment.fleet_sim(model, uplink=shaped(mbps),
                                           rate_hz=rate_hz,
                                           max_batch=max_batch,
                                           max_wait_s=max_wait_ms / 1e3)
        row["fleet_p95_ms"] = fleet.p95(n_clients) * 1e3
        row["n_servers"] = cfg.n_servers
        row["router"] = cfg.router
        print(f"  N={n_clients} fleet ({cfg.n_servers} servers, "
              f"{cfg.router}): p95 {row['fleet_p95_ms']:.4f} ms")
    if real_fleet:
        row.update(run_real_fleet(setup, n_clients=n_clients,
                                  rate_hz=rate_hz))
    return row


def run_real_fleet(setup: ServingSetup, *, n_clients: int = 8,
                   rate_hz: float = 10.0, duration_s: float = 2.0,
                   timeout_s: float = 30.0) -> dict:
    """Measured p95 of the manifest's REAL fleet against the loopback sim.

    The service curve is re-measured on ``Deployment.server_batch_fn``
    as the workers serve it (no benchmark-local head), so the sim's
    prediction and the spawned fleet charge the same t(B); the uplink is
    the localhost loopback, so both sides see negligible transfer time.
    The workers serve on the setup's device.
    """
    from repro_torch.serving.realfleet import pack_payload, run_load

    dep = setup.deployment
    cfg = dep.config
    payload = setup.edge_fn(setup.obs)
    srv = dep.server(setup.params)
    srv.measure(payload, batch_sizes=tuple(
        b for b in (1, 2, 4, 8, 16) if b <= cfg.max_batch), iters=10)
    model = srv.service_model()
    fleet = dep.fleet(setup.params, service_model=model,
                      timeout_s=timeout_s)
    try:
        sim = dep.fleet_sim(model, uplink=shaped(10_000.0, rtt_ms=0.2),
                            rate_hz=rate_hz, horizon_s=duration_s,
                            max_batch=fleet.max_batch, max_wait_s=0.0)
        predicted = sim.p95(n_clients)
        rep = run_load(fleet.client, pack_payload(payload),
                       n_clients=n_clients, rate_hz=rate_hz,
                       duration_s=duration_s)
    finally:
        leaked = fleet.close()
    out = {"real_predicted_p95_ms": predicted * 1e3,
           "real_measured_p95_ms": rep.p95() * 1e3,
           "real_measured_p50_ms": rep.p50() * 1e3,
           "real_n_requests": rep.n_requests,
           "real_n_failures": rep.n_failures,
           "real_max_served_batch": fleet.stats["max_served_batch"],
           "real_leaked_workers": len(leaked),
           "real_startup_s": fleet.startup_s, "real_close_s": fleet.close_s}
    print(f"  N={n_clients} REAL fleet ({cfg.n_servers} servers, "
          f"{cfg.router}, localhost, {dep.device}): measured p95 "
          f"{out['real_measured_p95_ms']:.4f} ms vs loopback-sim "
          f"{out['real_predicted_p95_ms']:.4f} ms "
          f"({rep.n_requests} reqs, {rep.n_failures} failed, "
          f"{len(leaked)} leaked)")
    return out


def load_manifest(path: str) -> DeploymentConfig:
    """Load a serialised DeploymentConfig (``python -m repro_torch.deploy``
    or ``python -m repro.deploy``)."""
    with open(path) as f:
        return DeploymentConfig.from_dict(json.load(f))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bandwidths", default="10,25,50,100")
    ap.add_argument("--decisions", type=int, default=1000)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--manifest", default=None,
                    help="deployment manifest JSON to build the pipeline "
                         "from (overrides --k)")
    ap.add_argument("--clients", type=int, default=8,
                    help="N clients for the FIFO-vs-batched p95 report "
                         "(0 disables)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--real-fleet", action="store_true",
                    help="also spawn the manifest's real multi-process "
                         "fleet on localhost and report measured p95 "
                         "next to the loopback sim prediction")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    config = load_manifest(args.manifest) if args.manifest else None
    setup = build(k=args.k, config=config, device=args.device)
    run(tuple(float(b) for b in args.bandwidths.split(",")),
        n_decisions=args.decisions, setup=setup)
    if args.clients:
        run_queue(n_clients=args.clients, max_batch=args.max_batch,
                  setup=setup, real_fleet=args.real_fleet)


if __name__ == "__main__":
    main()
