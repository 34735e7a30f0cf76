"""Sim-to-real fleet calibration: FleetQueueSim against the real fleet
(port of the reference's ``benchmarks/realfleet.py``).

:class:`repro_torch.serving.fleet.FleetQueueSim` says what ``n_servers``
micro-batching servers behind a router SHOULD do.  This benchmark runs
that deployment for real (``repro_torch.serving.realfleet``: spawned
worker processes on ``--device``, localhost sockets, the same registered
routers) and reports measured p95 decision latency next to the sim's
prediction, per (n_servers, router) cell.

Methodology: one manifest gives BOTH sides.  The batched service curve
t(B) is measured in-process first on the device (that curve drives the
sim AND caps the real fleet's admission at its largest measured batch),
the uplink is modelled as the localhost loopback (effectively unshaped),
and the SAME open-loop load (N clients at ``--rate-hz``, the Table 6
protocol) is applied to the simulator and to the live fleet.  With
``--shaped-mbps R`` every worker token-bucket-shapes its request ingress
at R Mb/s (``ShapingConfig``) and the sim uplink is modelled at the same
rate; the shaping config is stamped into every row and the artifact.

On the card, the N workers are N processes sharing one GPU: their
kernels time-slice; the sim assumes N independent servers.

Rows are written to ``build/realfleet.json`` (never the reference's
committed ``BENCH_realfleet.json``) stamped ``transport: "socket"``;
``--against`` exits 2 on a sim-stamped or unstamped baseline, because a
sim-vs-real delta is a calibration, not a regression.

``--smoke`` is the bounded gate: every cell's measured p95 within
``tol_rel * predicted + tol_abs`` of the sim, zero failed requests and
zero leaked worker processes.

    python -m repro_torch.benchmarks.realfleet --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch import perfstamp
from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.serving.fleet import router_names
from repro_torch.serving.netsim import shaped
from repro_torch.serving.realfleet import ShapingConfig, pack_payload, run_load

ARTIFACT = str(BUILD_DIR.parent / "realfleet.json")

# localhost loopback stand-in for the shaped uplink: multi-Gb/s and
# ~0.1 ms RTT, so transfer time is negligible against service time, which
# is what the real fleet's clients see
LOOPBACK_MBPS = 10_000.0
LOOPBACK_RTT_MS = 0.2


def small_config(*, n_servers: int = 2,
                 router: str = "round_robin") -> DeploymentConfig:
    """The calibration deployment: small enough that worker spawn and
    warm-up stay bounded, big enough that t(B) is measurable."""
    return DeploymentConfig.standard(k=4, c_in=4, h=24, backend="xla",
                                     max_batch=4, n_servers=n_servers,
                                     router=router)


def calibrate(cfg: DeploymentConfig, *, n_servers_list=(1, 2),
              routers=None, n_clients: int = 4, rate_hz: float = 20.0,
              duration_s: float = 1.5, seed: int = 0,
              timeout_s: float = 30.0, shaped_mbps: float = None,
              device=None) -> list[dict]:
    """Measured against predicted p95 per (n_servers, router) cell, on
    ``device`` (``cuda`` by default).

    ONE fleet is spawned per fleet size and re-used across routers
    (routing is a parent-side decision, as in the sim), so the spawn and
    warm-up are paid once per size, not once per cell.
    ``shaped_mbps`` shapes every worker's request ingress and models the
    sim uplink at the same rate.
    """
    dep = Deployment.build(cfg, device=device)
    params = dep.init(torch.Generator().manual_seed(seed))
    client, bsrv = dep.serving_pair(params)
    obs = torch.rand((1, cfg.in_h, cfg.in_w, cfg.spec.layers[0].c_in),
                     generator=torch.Generator().manual_seed(seed + 1))
    payload = client.encode_fn(obs.to(dep.device))
    body = pack_payload(payload)

    times = bsrv.measure(payload, batch_sizes=tuple(
        b for b in (1, 2, 4, 8) if b <= cfg.max_batch), iters=10)
    model = bsrv.service_model()
    curve = " ".join(f"t({b})={t*1e3:.4f}ms"
                     for b, t in sorted(times.items()))
    print(f"  measured service curve on {dep.device}: {curve}")

    shaping = (None if shaped_mbps is None
               else ShapingConfig(rate_mbps=shaped_mbps))
    uplink_mbps = LOOPBACK_MBPS if shaped_mbps is None else shaped_mbps
    uplink_rtt_ms = LOOPBACK_RTT_MS if shaped_mbps is None else 2.0
    if shaping is not None:
        print(f"  ingress shaping: {shaping.rate_mbps} Mb/s token bucket, "
              f"burst {shaping.burst_bytes} B (sim uplink matched)")

    routers = tuple(routers) if routers else router_names()
    rows = []
    for ns in sorted(set(n_servers_list)):
        fleet = dep.fleet(params, n_servers=ns, service_model=model,
                          timeout_s=timeout_s, shaping=shaping)
        fleet_rows = []
        try:
            for router in routers:
                fleet.set_router(router)
                sim = dep.fleet_sim(
                    model, uplink=shaped(uplink_mbps,
                                         rtt_ms=uplink_rtt_ms),
                    rate_hz=rate_hz, horizon_s=duration_s, n_servers=ns,
                    router=router, max_batch=fleet.max_batch,
                    max_wait_s=0.0)
                predicted = sim.p95(n_clients)
                rep = run_load(fleet.client, body, n_clients=n_clients,
                               rate_hz=rate_hz, duration_s=duration_s)
                fleet_rows.append({
                    "n_servers": ns, "router": router,
                    "n_clients": n_clients, "rate_hz": rate_hz,
                    "duration_s": duration_s,
                    "shaping": None if shaping is None
                    else shaping.to_dict(),
                    "n_requests": rep.n_requests,
                    "n_failures": rep.n_failures,
                    "predicted_p95_ms": predicted * 1e3,
                    "measured_p95_ms": rep.p95() * 1e3,
                    "measured_p50_ms": rep.p50() * 1e3,
                    "max_served_batch":
                        fleet.stats["max_served_batch"],
                })
                r = fleet_rows[-1]
                print(f"  {ns}x {router:<16} N={n_clients} "
                      f"predicted p95 {r['predicted_p95_ms']:8.4f} ms  "
                      f"measured p95 {r['measured_p95_ms']:8.4f} ms "
                      f"(p50 {r['measured_p50_ms']:.4f} ms, "
                      f"{rep.n_requests} reqs, {rep.n_failures} failed, "
                      f"max batch {r['max_served_batch']})")
        finally:
            leaked = fleet.close()
        print(f"  {ns}x fleet on {fleet.device}: started in "
              f"{fleet.startup_s:.2f} s, drained and joined in "
              f"{fleet.close_s:.2f} s")
        for r in fleet_rows:
            r["leaked_workers"] = len(leaked)
        rows.extend(fleet_rows)
        if leaked:
            print(f"  WARNING: {ns}x fleet leaked worker pids {leaked}")
    return rows


def write_artifact(rows: list[dict], cfg: DeploymentConfig,
                   *, path: str = ARTIFACT,
                   shaping: ShapingConfig = None, device=None) -> dict:
    doc = perfstamp.stamp({"kind": "realfleet_calibration",
                           "config": cfg.to_dict(),
                           "shaping": None if shaping is None
                           else shaping.to_dict(),
                           "rows": rows},
                          backend=cfg.backend, device=device or "cuda",
                          transport="socket")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"  wrote {path} [mode={doc['mode']} transport={doc['transport']}]")
    return doc


def check_against(baseline_path: str, *, artifact: str = ARTIFACT) -> list:
    """Refuse cross-transport comparisons: a socket-measured artifact is
    only comparable with another socket-measured artifact (sim-vs-real is
    calibration, handled above, never a perf diff)."""
    with open(artifact) as f:
        current = json.load(f)
    with open(baseline_path) as f:
        baseline = json.load(f)
    perfstamp.check_comparable(current, baseline,
                               what=f"{artifact} vs {baseline_path}")
    soft = perfstamp.mismatches(current, baseline)
    for m in soft:
        print(f"  warning: {m}")
    print(f"  {artifact} comparable with {baseline_path} "
          f"[mode={current.get('mode')} "
          f"transport={current.get('transport')}]")
    return soft


def smoke_gate(rows: list[dict], *, tol_rel: float = 3.0,
               tol_abs_ms: float = 25.0) -> bool:
    """Every cell's measured p95 within one-sided tolerance of the sim
    prediction, zero failures, zero leaked workers.

    One-sided because the sim is an idealised lower bound: it does not
    model OS scheduling, GIL contention between the load generator's
    threads, socket syscalls, or N worker processes time-slicing one
    card, so measured < predicted is fine and only measured >> predicted
    points at a broken serving path (a batch hold, a warm-up in the hot
    loop)."""
    ok = True
    for r in rows:
        bound = tol_rel * r["predicted_p95_ms"] + tol_abs_ms
        cell_ok = (r["measured_p95_ms"] <= bound
                   and r["n_failures"] == 0
                   and r["leaked_workers"] == 0)
        print(f"  gate {r['n_servers']}x {r['router']:<16} measured "
              f"{r['measured_p95_ms']:8.4f} ms <= {bound:8.4f} ms, "
              f"failures={r['n_failures']}, "
              f"leaked={r['leaked_workers']}: {cell_ok}")
        ok = ok and cell_ok
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifest", default=None,
                    help="deployment manifest JSON (see python -m "
                         "repro_torch.deploy); default: the small "
                         "calibration deployment")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions); the "
                         "workers serve on it too")
    ap.add_argument("--n-servers", default="1,2",
                    help="comma-separated fleet sizes to spawn")
    ap.add_argument("--routers", default=None,
                    help="comma-separated routing policies (default: all "
                         "registered)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rate-hz", type=float, default=20.0)
    ap.add_argument("--duration-s", type=float, default=1.5)
    ap.add_argument("--shaped-mbps", type=float, default=None,
                    help="token-bucket-shape worker request ingress at "
                         "this rate and model the sim uplink to match "
                         "(default: unshaped loopback)")
    ap.add_argument("--smoke", action="store_true",
                    help="bounded gate: measured p95 within tolerance of "
                         "the FleetQueueSim prediction, no failed "
                         "requests, no leaked workers (exit 1 on failure)")
    ap.add_argument("--tol-rel", type=float, default=3.0)
    ap.add_argument("--tol-abs-ms", type=float, default=25.0)
    ap.add_argument("--out", default=ARTIFACT)
    ap.add_argument("--against", metavar="OLD.json",
                    help="check the written artifact is comparable with "
                         "OLD.json (exit 2 on a mode or transport "
                         "mismatch, e.g. sim-vs-real)")
    args = ap.parse_args(argv)

    if args.manifest:
        with open(args.manifest) as f:
            cfg = DeploymentConfig.from_dict(json.load(f))
    else:
        cfg = small_config()
    sizes = tuple(int(s) for s in args.n_servers.split(","))
    routers = tuple(args.routers.split(",")) if args.routers else None

    rows = calibrate(cfg, n_servers_list=sizes, routers=routers,
                     n_clients=args.clients, rate_hz=args.rate_hz,
                     duration_s=args.duration_s,
                     shaped_mbps=args.shaped_mbps, device=args.device)
    write_artifact(rows, cfg, path=args.out,
                   shaping=None if args.shaped_mbps is None
                   else ShapingConfig(rate_mbps=args.shaped_mbps),
                   device=args.device)
    if args.smoke:
        ok = smoke_gate(rows, tol_rel=args.tol_rel,
                        tol_abs_ms=args.tol_abs_ms)
        print(f"  smoke: all calibration cells within tolerance, no "
              f"failures, no leaked workers: {ok}")
        if not ok:
            raise SystemExit(1)
    if args.against:
        try:
            check_against(args.against, artifact=args.out)
        except ValueError as e:
            print(f"  REFUSED: {e}")
            raise SystemExit(2)


if __name__ == "__main__":
    main()
