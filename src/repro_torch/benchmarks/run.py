"""Benchmark orchestrator: one section per paper table or figure (port of
the reference's ``benchmarks/run.py``).

Runs the port's benchmarks in the reference's order and with its
arguments — Tables 2–4 (``learning``), Figures 2–3 (``frame_time``,
``sustained``), Tables 5–6 (``decision_latency``, ``scalability``), Eq. 1
(``break_even``), the roofline and MiniConv tables — then prints every
section's numbers as ``name,metric,value`` CSV rows.  Smoke scale: each
section's module has a command line for paper-scale runs.

    python -m repro_torch.benchmarks.run [--device cpu]

``--device`` (default ``cuda``) reaches every section that takes one.
"""
from __future__ import annotations

import argparse
import time


def section(title):
    print(f"\n==== {title} " + "=" * max(0, 60 - len(title)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    dev = ap.parse_args(argv).device
    t0 = time.time()
    csv: list[tuple[str, str, float]] = []

    section("Table 2-4: learning (smoke scale)")
    from repro_torch.benchmarks import learning
    rows = learning.run(total_steps=512, tasks=("pendulum",),
                        encoders=("miniconv4", "full_cnn"), device=dev)
    for r in rows:
        csv.append((f"learning/{r.task}/{r.encoder}", "final_return",
                    r.final))

    section("Figure 2: per-frame time vs input size (fused vs per-pass)")
    from repro_torch.benchmarks import frame_time
    for row in frame_time.run_compare(sizes=(64, 128), n=10,
                                      device=dev)[0]:
        for mode in ("xla", "fused", "per_pass"):
            csv.append((f"frame_time/x{row['x']}", f"{mode}_ms",
                        row[f"{mode}_ms"]))

    section("Figure 3: sustained inference")
    from repro_torch.benchmarks import sustained
    out = sustained.run(n_frames=100, x_size=128, device=dev)
    for name, d in out.items():
        csv.append((f"sustained/{name}", "mean_ms", d["mean_ms"]))
        csv.append((f"sustained/{name}", "drift_pct", d["drift_pct"]))

    section("Table 5: decision latency under bandwidth shaping")
    from repro_torch.benchmarks import decision_latency
    for row in decision_latency.run(n_decisions=200, device=dev):
        csv.append((f"latency/{row['mbps']:g}mbps", "server_only_ms",
                    row["server_only_ms"]))
        csv.append((f"latency/{row['mbps']:g}mbps", "split_ms",
                    row["split_ms"]))

    section("Table 6: server scalability (FIFO vs micro-batched)")
    from repro_torch.benchmarks import scalability
    rows6, p95s6 = scalability.run(n_max=128, device=dev)
    for name, n in rows6.items():
        csv.append((f"scalability/{name}", "max_clients", float(n)))
    for n, (fifo_ms, batched_ms) in p95s6.items():
        csv.append((f"scalability/n{n}", "fifo_p95_ms", fifo_ms))
        csv.append((f"scalability/n{n}", "batched_p95_ms", batched_ms))

    section("Eq. 1: break-even bandwidth")
    from repro_torch.benchmarks import break_even
    for row in break_even.run():
        csv.append((f"break_even/{row['config']}", "pred_mbps",
                    row["pred"]))
        csv.append((f"break_even/{row['config']}", "sim_mbps", row["sim"]))

    section("Roofline table (from dry-run artifacts, if present)")
    from repro_torch.benchmarks import roofline_table
    roofline_table.main([])

    section("MiniConv pass-plan roofline")
    roofline_table.miniconv_table()

    section("CSV")
    print("name,metric,value")
    for name, metric, value in csv:
        print(f"{name},{metric},{value:.4f}")
    print(f"\ntotal bench time {time.time()-t0:.1f}s")


__all__ = ["main", "section"]


if __name__ == "__main__":
    main()
