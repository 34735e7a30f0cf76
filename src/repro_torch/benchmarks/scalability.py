"""Paper Table 6 on the card: server scalability at a fixed decision rate
(port of the reference's ``benchmarks/scalability.py``).

Max concurrent clients a single server sustains at 10 Hz within a p95
decision-latency budget of 100 ms, server-only against split-policy, and
split-policy with server-side MICRO-BATCHING: the server serves up to
``--max-batch`` queued requests with one batched call whose service time
t(B) is measured on ``--device`` (``cuda`` by default) from the real
batched network.  Queueing is the deterministic FIFO / batch-aware
simulation (``repro_torch.serving.server``).  A row that reaches the
search cap ``n_max`` reports the cap: the capacity is at least that.

The FLEET table extends Table 6 to ``n_servers`` sharded servers behind
each routing policy (``repro_torch.serving.fleet``): supported clients
against fleet size, every server charging the same measured t(B) curve,
all fed from the shared shaped uplink.  The fleet shape comes from the
manifest (``DeploymentConfig.n_servers`` / ``router``).

``--smoke`` is the reference's gate: at N=8 clients the micro-batched p95
must not exceed 1.05 x the FIFO p95, and the fleet table must be monotone
(more servers never supports fewer clients, for every router) with at
least 2x the clients at 4 servers.  ``--manifest`` builds the pipeline
from a serialised :class:`repro_torch.deploy.DeploymentConfig`.
``--real-fleet`` then holds the tables' predictions against the real
spawned fleet (``benchmarks.realfleet``, 1 and 2 servers, the manifest or
the small calibration deployment), writing ``build/realfleet.json``.

    python -m repro_torch.benchmarks.scalability --smoke
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.decision_latency import (build, load_manifest,
                                                     measure_service_curve)
from repro_torch.serving.fleet import router_names
from repro_torch.serving.netsim import shaped
from repro_torch.serving.server import BatchQueueSim, PolicyServer, QueueSim


def run(*, mbps: float = 100.0, rate_hz: float = 10.0,
        budget_ms: float = 100.0, n_max: int = 256, max_batch: int = 8,
        max_wait_ms: float = 0.0, iters: int = 10, horizon_s: float = 5.0,
        config=None, setup=None, model=None, device=None):
    setup = setup or build(config=config, device=device)
    s_mono = PolicyServer(serve_fn=setup.mono_server_fn).measure(
        setup.obs, iters=iters)
    if model is None:
        _, model = measure_service_curve(setup, max_batch=max_batch,
                                         max_wait_s=max_wait_ms / 1e3,
                                         iters=iters)
    s_split = model(1)

    sims = {
        "server_only": (QueueSim(service_time_s=s_mono, uplink=shaped(mbps),
                                 payload_bytes=setup.frame_bytes,
                                 rate_hz=rate_hz, horizon_s=horizon_s),
                        s_mono, setup.frame_bytes),
        "split_fifo": (QueueSim(service_time_s=s_split, uplink=shaped(mbps),
                                payload_bytes=setup.wire_bytes,
                                rate_hz=rate_hz, horizon_s=horizon_s),
                       s_split, setup.wire_bytes),
        "split_batched": (BatchQueueSim(service_time_s=s_split,
                                        uplink=shaped(mbps),
                                        payload_bytes=setup.wire_bytes,
                                        rate_hz=rate_hz, horizon_s=horizon_s,
                                        max_batch=max_batch,
                                        max_wait_s=max_wait_ms / 1e3,
                                        service_model=model),
                          s_split, setup.wire_bytes),
    }
    rows = {}
    for name, (sim, svc, payload_bytes) in sims.items():
        rows[name] = sim.max_clients(p95_budget_s=budget_ms / 1e3,
                                     n_max=n_max)
        capped = " (search cap)" if rows[name] >= n_max else ""
        print(f"  {name:<13} service={svc*1e3:8.4f}ms payload="
              f"{payload_bytes:>7}B -> {rows[name]:>4} clients{capped} "
              f"@ {rate_hz:.0f}Hz p95<{budget_ms:.0f}ms")
    ratio = rows["split_fifo"] / max(rows["server_only"], 1)
    bound = " (a lower bound: split FIFO hit the search cap)" \
        if rows["split_fifo"] >= n_max else ""
    print(f"  scaling factor (split FIFO): {ratio:.1f}x{bound}")
    batch_ratio = rows["split_batched"] / max(rows["split_fifo"], 1)
    print(f"  micro-batching gain over FIFO: {batch_ratio:.1f}x "
          f"(max_batch={max_batch})")

    p95s = {}
    for n in (8, min(32, n_max)):
        f = sims["split_fifo"][0].p95(n) * 1e3
        b = sims["split_batched"][0].p95(n) * 1e3
        p95s[n] = (f, b)
        print(f"  N={n:>3}: split p95 FIFO {f:8.4f} ms vs batched "
              f"{b:8.4f} ms")
    return rows, p95s


def fleet_table(setup, model, *, mbps: float = 100.0, rate_hz: float = 10.0,
                budget_ms: float = 100.0, horizon_s: float = 2.0,
                n_servers_list=(1, 2, 4, 8), routers=None,
                n_max: int = 4096, max_batch=None, max_wait_s=None):
    """Clients supported against fleet size, per routing policy.

    Payload bytes, micro-batching policy and the configured fleet shape
    come from ``setup.deployment``; ``model`` is the measured t(B) curve
    charged by every server.  The configured ``n_servers`` is always in
    the sweep.
    """
    dep = setup.deployment
    routers = tuple(routers) if routers else router_names()
    sizes = sorted(set(n_servers_list) | {dep.config.n_servers})
    # batching-policy overrides keep the sim on the SAME policy the t(B)
    # curve was measured under when the CLI deviates from the manifest
    base = dep.fleet_sim(model, uplink=shaped(mbps), rate_hz=rate_hz,
                         horizon_s=horizon_s, max_batch=max_batch,
                         max_wait_s=max_wait_s)
    table = {}
    for router in routers:
        marker = " (configured)" if router == dep.config.router else ""
        table[router] = {
            s: base.with_servers(s, router).max_clients(
                p95_budget_s=budget_ms / 1e3, n_max=n_max)
            for s in sizes}
        cells = "  ".join(f"{s}x:{table[router][s]:>5}" for s in sizes)
        print(f"  fleet {router:<16} {cells}{marker}")
    return table


def check_fleet_monotone(table, *, min_gain_at_4x: float = 0.0,
                         n_max: int = None) -> bool:
    """The --smoke fleet gate: more servers never supports fewer clients
    (per routing policy), and optionally 4 servers must carry at least
    ``min_gain_at_4x`` times the single-server population.  A 4-server
    row that reaches the ``n_max`` search cap passes the gain check: its
    capacity is at least the measurable bound."""
    ok = True
    for router, row in table.items():
        sizes = sorted(row)
        mono = all(row[a] <= row[b] for a, b in zip(sizes, sizes[1:]))
        gain = row[4] / max(row[1], 1) if {1, 4} <= set(sizes) else None
        capped = gain is not None and n_max is not None and row[4] >= n_max
        scaled = gain is None or capped or gain >= min_gain_at_4x
        print(f"  fleet gate {router:<16} monotone={mono}"
              + (f" gain@4x={gain:.1f}" if gain is not None else "")
              + (" (>= search cap)" if capped else ""))
        ok = ok and mono and scaled
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mbps", type=float, default=100.0)
    ap.add_argument("--fleet-mbps", type=float, default=1000.0,
                    help="shared ingress bandwidth for the FLEET table "
                         "(a fleet front door is provisioned beyond the "
                         "paper's single 100 Mb/s shaped link)")
    ap.add_argument("--budget-ms", type=float, default=100.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true",
                    help="fast gate: batched p95 <= 1.05 x FIFO p95 at N=8 "
                         "clients, and the fleet table is monotone in "
                         "n_servers with >= 2x clients at 4 servers")
    ap.add_argument("--no-fleet", action="store_true",
                    help="skip the fleet table (single-server rows only)")
    ap.add_argument("--real-fleet", action="store_true",
                    help="after the tables, calibrate their predictions "
                         "against the REAL spawned fleet on localhost "
                         "(benchmarks.realfleet; uses the manifest when "
                         "given, else the small calibration deployment)")
    ap.add_argument("--manifest", default=None,
                    help="deployment manifest JSON to build the pipeline "
                         "from (see python -m repro_torch.deploy)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    config = load_manifest(args.manifest) if args.manifest else None
    setup = build(config=config, device=args.device)
    if args.smoke:
        _, model = measure_service_curve(setup, max_batch=args.max_batch,
                                         max_wait_s=args.max_wait_ms / 1e3,
                                         iters=5)
        rows, p95s = run(mbps=args.mbps, budget_ms=args.budget_ms,
                         max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         n_max=64, iters=5, horizon_s=2.0,
                         setup=setup, model=model)
        fifo, batched = p95s[8]
        # 5% relative tolerance: both sims are driven by a wall-clock
        # measured t(B) curve, and one noisy sample can make the curve
        # locally superlinear without any code regression
        ok = batched <= 1.05 * fifo + 1e-9
        print(f"  smoke: batched p95 {batched:.4f} ms <= 1.05 * FIFO p95 "
              f"{fifo:.4f} ms at N=8: {ok}")
        if args.no_fleet:
            fleet_ok = True
        else:
            table = fleet_table(setup, model, mbps=args.fleet_mbps,
                                budget_ms=args.budget_ms, horizon_s=2.0,
                                n_max=2048, max_batch=args.max_batch,
                                max_wait_s=args.max_wait_ms / 1e3)
            fleet_ok = check_fleet_monotone(table, min_gain_at_4x=2.0,
                                            n_max=2048)
            print(f"  smoke: fleet monotone in n_servers with >= 2x "
                  f"clients at 4 servers: {fleet_ok}")
        if not (ok and fleet_ok):
            raise SystemExit(1)
    else:
        _, model = measure_service_curve(setup, max_batch=args.max_batch,
                                         max_wait_s=args.max_wait_ms / 1e3)
        run(mbps=args.mbps, budget_ms=args.budget_ms,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            setup=setup, model=model)
        if not args.no_fleet:
            fleet_table(setup, model, mbps=args.fleet_mbps,
                        budget_ms=args.budget_ms,
                        max_batch=args.max_batch,
                        max_wait_s=args.max_wait_ms / 1e3)
    if args.real_fleet:
        # the sim tables above are predictions; close the loop by running
        # the same deployment as real worker processes and comparing p95
        from repro_torch.benchmarks.realfleet import (calibrate,
                                                      small_config,
                                                      write_artifact)
        rcfg = config or small_config()
        print("  real-fleet calibration (localhost, measured vs "
              "predicted):")
        rows = calibrate(rcfg, n_servers_list=(1, 2), device=args.device)
        write_artifact(rows, rcfg, device=args.device)


if __name__ == "__main__":
    main()
