"""Scenario grid: (scenario x router x adaptation) under the fleet sim
(port of the reference's ``benchmarks/scenarios.py``).

``repro_torch.serving.scenario`` names whole serving CONDITIONS
(adversarial link shapes, device zoos, adaptation-mode ladders) as seeded,
frozen schemas.  This benchmark sweeps every selected scenario through the
routing policies and adaptation controllers that apply to it and writes
one scorecard row per cell: p95 / mean decision latency, deadline hit
rate, the delivered-return proxy (mode fidelity for in-deadline
decisions, zero for late ones), and the uplink byte bill.  It is pure
simulation on the host, so its rows equal the reference's bit for bit.

Rows go to ``build/scenarios.json`` (never the reference's committed
``BENCH_scenarios.json``) stamped ``transport: "sim"`` with the full
scenario definitions embedded, so a baseline carries its own seeds.
``--against`` refuses apples-to-oranges diffs twice over: a transport or
mode mismatch (sim-vs-real) exits 2 via ``perfstamp.check_comparable``,
and so does a baseline whose (name, seed) scenario set shares nothing
with the current run.

``--smoke`` is the bounded gate, run on the designed deterministic
adversary ``trace_dropout`` (two 1 s dropouts to 4 Mb/s on a 100 Mb/s
uplink): the rule controller must beat the BEST STATIC configuration
(best by delivered return, the config you would deploy without
adaptation) on all three axes at once: delivered return no lower, p95 no
higher, uplink bytes no higher.

Grid bounds: single-device scenarios run at n_servers=1 where every
router is identical, so only ``round_robin`` is swept; device-zoo
scenarios run one server per profile and sweep every registered router.

    python -m repro_torch.benchmarks.scenarios --smoke
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch import perfstamp
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.serving.fleet import router_names
from repro_torch.serving.scenario import get_scenario, scenario_names

ARTIFACT = str(BUILD_DIR.parent / "scenarios.json")
GATE_SCENARIO = "trace_dropout"
PAYLOAD_BYTES = 10_000    # the reference wire payload (fp32 z at X=50-ish)


def adaptations_for(scenario) -> tuple:
    """The controllers that make sense for this scenario's mode ladder:
    the no-adaptation default, one static per non-default mode, and the
    rule controller when there is actually a ladder to climb."""
    pols = ["none"]
    pols += [f"static:{i}" for i in range(1, len(scenario.modes))]
    if len(scenario.modes) > 1:
        pols.append("rule")
    return tuple(pols)


def run_cell(scenario, *, router: str, adaptation: str,
             payload_bytes: int, n_servers: int) -> dict:
    sim = scenario.sim(payload_bytes, n_servers=n_servers, router=router,
                       adaptation=adaptation)
    rep = sim.report(scenario.n_clients)
    return {
        "scenario": scenario.name, "seed": scenario.seed,
        "adversarial": scenario.adversarial,
        "router": router, "n_servers": n_servers,
        "adaptation": adaptation, "payload_bytes": payload_bytes,
        "n_requests": rep.n_requests,
        "p95_ms": rep.p95_s * 1e3,
        "mean_ms": rep.mean_s * 1e3,
        "deadline_hit_rate": rep.deadline_hit_rate,
        "delivered_return": rep.delivered_return,
        "total_uplink_bytes": rep.total_uplink_bytes,
        "mode_counts": rep.mode_counts(),
    }


def sweep(names, *, payload_bytes: int = PAYLOAD_BYTES) -> list[dict]:
    rows = []
    for name in names:
        s = get_scenario(name)
        n_servers = max(1, len(s.devices))
        routers = router_names() if n_servers > 1 else ("round_robin",)
        for router in routers:
            for pol in adaptations_for(s):
                r = run_cell(s, router=router, adaptation=pol,
                             payload_bytes=payload_bytes,
                             n_servers=n_servers)
                rows.append(r)
                print(f"  {s.name:<16} {router:<16} {pol:<10} "
                      f"p95 {r['p95_ms']:8.2f} ms  "
                      f"return {r['delivered_return']:.4f}  "
                      f"hit {r['deadline_hit_rate']:.3f}  "
                      f"{r['total_uplink_bytes']/1e6:7.3f} MB")
    return rows


def write_artifact(rows: list[dict], names, *,
                   payload_bytes: int, path: str = ARTIFACT) -> dict:
    doc = perfstamp.stamp(
        {"kind": "scenario_grid", "payload_bytes": payload_bytes,
         "scenarios": {n: get_scenario(n).to_dict() for n in names},
         "rows": rows},
        backend="sim", device="cpu", transport="sim")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"  wrote {path} [mode={doc['mode']} transport={doc['transport']}]")
    return doc


def _scenario_keys(doc: dict) -> set:
    return {(n, s.get("seed")) for n, s in doc.get("scenarios", {}).items()}


def check_against(baseline_path: str, *, artifact: str = ARTIFACT) -> None:
    """Refuse cross-transport AND cross-scenario comparisons: the
    baseline must be sim-stamped like us (sim-vs-real is a calibration,
    see ``benchmarks.realfleet``) and must share at least one
    (scenario name, seed) with the current run: a diff across different
    scenarios or reseeded links is a different experiment."""
    with open(artifact) as f:
        current = json.load(f)
    with open(baseline_path) as f:
        baseline = json.load(f)
    perfstamp.check_comparable(current, baseline,
                               what=f"{artifact} vs {baseline_path}")
    cur, base = _scenario_keys(current), _scenario_keys(baseline)
    common = cur & base
    if not common:
        raise ValueError(
            f"no common (scenario, seed) between {artifact} "
            f"{sorted(cur)} and {baseline_path} {sorted(base)}: "
            f"cross-scenario comparison refused")
    for m in perfstamp.mismatches(current, baseline):
        print(f"  warning: {m}")
    print(f"  {artifact} comparable with {baseline_path} on "
          f"{len(common)} shared scenario(s) "
          f"[mode={current.get('mode')} "
          f"transport={current.get('transport')}]")


def smoke_gate(rows: list[dict], *,
               scenario: str = GATE_SCENARIO) -> bool:
    """The adaptation gate on the designed deterministic adversary.

    Statics are ranked by delivered return (the config you would deploy
    without adaptation); the rule controller must match-or-beat that
    best static on return, p95 AND uplink bytes simultaneously."""
    cells = [r for r in rows
             if r["scenario"] == scenario and r["n_servers"] == 1]
    statics = [r for r in cells if r["adaptation"] != "rule"]
    rules = [r for r in cells if r["adaptation"] == "rule"]
    if not statics or not rules:
        print(f"  gate: scenario {scenario!r} missing static or rule "
              f"cells: did the sweep include it?")
        return False
    best = max(statics, key=lambda r: r["delivered_return"])
    rule = rules[0]
    checks = (
        ("delivered_return >=",
         rule["delivered_return"] >= best["delivered_return"],
         f"{rule['delivered_return']:.4f} vs {best['delivered_return']:.4f}"),
        ("p95 <=", rule["p95_ms"] <= best["p95_ms"],
         f"{rule['p95_ms']:.2f} ms vs {best['p95_ms']:.2f} ms"),
        ("uplink bytes <=",
         rule["total_uplink_bytes"] <= best["total_uplink_bytes"],
         f"{rule['total_uplink_bytes']} vs {best['total_uplink_bytes']}"),
    )
    ok = True
    print(f"  gate [{scenario}]: rule vs best static "
          f"({best['adaptation']}, return-ranked)")
    for label, passed, detail in checks:
        print(f"    {label:<20} {detail}: {passed}")
        ok = ok and passed
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenario names (default: all "
                         "registered)")
    ap.add_argument("--payload-bytes", type=int, default=PAYLOAD_BYTES,
                    help="the deployment's default wire payload that "
                         "mode 0 sends")
    ap.add_argument("--smoke", action="store_true",
                    help="gate: on the designed adversarial scenario "
                         "the rule controller must match-or-beat the "
                         "best static configuration on delivered return, "
                         "p95 and uplink bytes (exit 1 on failure)")
    ap.add_argument("--out", default=ARTIFACT)
    ap.add_argument("--against", metavar="OLD.json",
                    help="check the written artifact is comparable with "
                         "OLD.json (exit 2 on transport/mode mismatch or "
                         "disjoint scenario sets)")
    args = ap.parse_args(argv)

    names = (tuple(args.scenarios.split(","))
             if args.scenarios else scenario_names())
    for n in names:
        get_scenario(n)            # fail fast on typos
    rows = sweep(names, payload_bytes=args.payload_bytes)
    write_artifact(rows, names, payload_bytes=args.payload_bytes,
                   path=args.out)
    if args.smoke:
        if GATE_SCENARIO not in names:
            print(f"  smoke requires the {GATE_SCENARIO!r} scenario in "
                  f"the sweep")
            raise SystemExit(1)
        ok = smoke_gate(rows)
        print(f"  smoke: rule controller dominates best static on "
              f"{GATE_SCENARIO}: {ok}")
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
