"""Paper Figure 2 on the card: per-frame encoder time against input size
(port of the reference's ``benchmarks/frame_time.py``).

Each (size, backend) cell is ONE :class:`~repro_torch.deploy.
DeploymentConfig` resolved by ``Deployment.build`` on ``--device``
(``cuda`` by default), timed on the host clock around a device
synchronize, mean and standard deviation of N calls after warm-up.  The
backends are the port's (``repro_torch.core.backends``): ``xla`` (eager
PyTorch), ``fused`` (K1), ``per_pass`` (the ``reference`` backend, K2),
``grouped`` (K3), ``fused+stream`` (K4).

* ``--compare`` times fused against per_pass against xla, and a batched
  fused launch against the same frames sent one by one.
* ``--tune`` runs the autotuner (``repro_torch.core.tuning``) per size and
  records the tuned against the default frame time.

Results go to ``build/frame_time.json``, stamped with the execution mode
and host by ``repro_torch.perfstamp``.  The reference's committed ``BENCH_frame_time.json`` is never written:
its numbers were measured elsewhere.  ``--against OLD.json`` refuses
(exit 2) to compare artifacts from different execution modes.

    python -m repro_torch.benchmarks.frame_time --tune
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from pathlib import Path

import torch

from repro_torch import perfstamp
from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.serving.server import _block

ARTIFACT = str(BUILD_DIR.parent / "frame_time.json")
COMMITTED = "BENCH_frame_time.json"      # the reference's, never written
C_IN = 4


def _write(doc: dict, artifact: str, *, backend, device) -> dict:
    """Stamp mode/host/backend onto ``doc`` and write it to ``artifact``."""
    doc = perfstamp.stamp(doc, backend=backend, device=device)
    path = Path(artifact)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=2))
    print(f"  wrote {artifact} [mode={doc['mode']} host={doc['host']}]")
    return doc


def _check_artifact(artifact) -> None:
    if artifact and Path(artifact).name == COMMITTED:
        raise ValueError(f"{COMMITTED} is the reference's committed "
                         f"artifact; write the port's elsewhere")


def _samples(fn, x, *, n: int, warm: int) -> list[float]:
    """Seconds of ``n`` calls, each window ended by a device synchronize
    (``_block``): CUDA launches return before the kernel ends."""
    for _ in range(warm):
        fn(x)
    _block()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _block(fn(x))
        ts.append(time.perf_counter() - t0)
    return ts


def time_frames(fn, x, *, n: int = 20, warm: int = 3) -> tuple[float, float]:
    """Mean and standard deviation, in seconds, of ``n`` synced calls."""
    ts = _samples(fn, x, n=n, warm=warm)
    return statistics.fmean(ts), statistics.pstdev(ts)


def median_frames(fn, x, *, n: int = 8, warm: int = 3) -> float:
    return statistics.median(_samples(fn, x, n=n, warm=warm))


def _deployment(x_size: int, mode: str, *, k: int, device,
                max_batch: int = 8) -> Deployment:
    """One declarative config per (input size, execution backend) cell."""
    return Deployment.build(DeploymentConfig.standard(
        k=k, c_in=C_IN, h=x_size, backend=mode, max_batch=max_batch),
        device=device)


def _path(dep: Deployment, edge_params):
    """The encoder-only (edge half) execution path of a deployment."""
    def fn(x):
        with torch.inference_mode():
            return dep.split.edge_apply(edge_params, x)
    return fn


def _edge_params(dep: Deployment, seed: int = 0):
    return dep.init(torch.Generator().manual_seed(seed))["edge"]


def _frames(batch: int, x_size: int, device) -> torch.Tensor:
    return torch.rand((batch, x_size, x_size, C_IN),
                      generator=torch.Generator().manual_seed(1)).to(device)


def run(sizes=(64, 128, 256, 400), *, k: int = 4, n: int = 20,
        modes=("xla",), device="cuda", artifact: str = ARTIFACT):
    _check_artifact(artifact)
    rows = []
    for x_size in sizes:
        row = {"x": x_size}
        for mode in modes:
            dep = _deployment(x_size, mode, k=k, device=device)
            mean, std = time_frames(_path(dep, _edge_params(dep)),
                                    _frames(1, x_size, dep.device), n=n)
            row[f"{mode}_ms"] = mean * 1e3
            row[f"{mode}_std_ms"] = std * 1e3
        row["fps5_ok"] = row[f"{modes[0]}_ms"] < 200.0
        rows.append(row)
        print("  " + " ".join(f"{kk}={v:.4f}" if isinstance(v, float)
                              else f"{kk}={v}" for kk, v in row.items()))
    if artifact:
        _write({"spec_k": k, "modes": list(modes), "rows": rows}, artifact,
               backend=",".join(modes), device=device)
    return rows


def run_compare(sizes=(64, 128, 256), *, k: int = 4, n: int = 20,
                batch: int = 8, device="cuda", artifact: str = ARTIFACT):
    """Fused against per_pass against xla, plus a batched fused launch
    against ``batch`` single-frame launches.  Returns (rows, ok): ``ok``
    when fused <= per_pass and batched <= sequential at every size."""
    _check_artifact(artifact)
    rows = run(sizes, k=k, n=n, modes=("xla", "fused", "per_pass"),
               device=device, artifact=None)
    for r in rows:
        dep = _deployment(r["x"], "fused", k=k, device=device)
        fused = _path(dep, _edge_params(dep))
        xb = _frames(batch, r["x"], dep.device)
        frames = [xb[i:i + 1] for i in range(batch)]

        def seq(frames_, _fused=fused):
            # the per-request serving path: B frames, B launches, each
            # synced like a real response
            for fr in frames_:
                out = _block(_fused(fr))
            return out

        n_b = max(n // 2, 5)
        r["fused_batched_ms"] = median_frames(fused, xb, n=n_b) * 1e3
        r["fused_seq_ms"] = median_frames(seq, frames, n=n_b) * 1e3
        r["batch"] = batch
    ok_fused = all(r["fused_ms"] <= r["per_pass_ms"] for r in rows)
    ok_batched = all(r["fused_batched_ms"] <= r["fused_seq_ms"]
                     for r in rows)
    for r in rows:
        print(f"  x={r['x']}: fused {r['fused_ms']:.4f}ms vs per_pass "
              f"{r['per_pass_ms']:.4f}ms, xla {r['xla_ms']:.4f}ms | "
              f"B={batch} batched {r['fused_batched_ms']:.4f}ms vs "
              f"sequential {r['fused_seq_ms']:.4f}ms")
    print(f"  fused <= per_pass at every size: {ok_fused}")
    print(f"  batched (B={batch}) <= {batch} sequential fused calls at "
          f"every size: {ok_batched}")
    if artifact:
        _write({"spec_k": k, "batch": batch, "rows": rows}, artifact,
               backend="xla,fused,per_pass", device=device)
    return rows, ok_fused and ok_batched


def run_tune(sizes=(48,), *, k: int = 4, n: int = 8, max_batch: int = 4,
             iters: int = 3, device="cuda", artifact: str = ARTIFACT):
    """Autotune each size and time the tuned against the default build.

    For every size one :class:`DeploymentConfig` (default ``fused``
    backend) goes to :func:`repro_torch.core.tuning.tune`, which prints
    every measured candidate; the winning
    :class:`TunedPlan` is frozen into the config and both builds encode
    the same ``max_batch`` frames.  When the winner IS the default cell
    the default time is reused, so timer noise cannot give a zero delta a
    sign.  Returns (rows, ok): ``ok`` when the tuned time is no slower than
    the default for at least one size.
    """
    from repro_torch.core.tuning import tune
    _check_artifact(artifact)
    rows = []
    for x_size in sizes:
        cfg = DeploymentConfig.standard(k=k, c_in=C_IN, h=x_size,
                                        max_batch=max_batch)
        print(f"  x={x_size}: candidates (launch time -> us a frame at "
              f"max_batch={max_batch})")
        tp = tune(cfg, iters=iters, device=device, log=print)
        dep_def = Deployment.build(cfg, device=device)
        dep_tun = Deployment.build(dataclasses.replace(cfg, tuning=tp),
                                   device=device)
        xb = _frames(max_batch, x_size, dep_def.device)
        fn_def = _path(dep_def, _edge_params(dep_def))
        default_ms = median_frames(fn_def, xb, n=n) * 1e3
        same_cell = (dep_tun.backend.name == dep_def.backend.name
                     and dep_tun.stream_chunk == dep_def.stream_chunk)
        if same_cell:
            tuned_ms = default_ms
        else:
            fn_tun = _path(dep_tun, _edge_params(dep_tun))
            tuned_ms = median_frames(fn_tun, xb, n=n) * 1e3
        row = {"x": x_size, "batch": max_batch,
               "default_backend": dep_def.backend.name,
               "default_ms": default_ms, "tuned_backend": tp.backend,
               "tuned_tile_h": tp.tile_h,
               "tuned_micro_batch": tp.micro_batch, "tuned_ms": tuned_ms,
               "same_cell": same_cell, "delta_ms": tuned_ms - default_ms,
               "searched": tp.searched, "pruned": tp.pruned}
        rows.append(row)
        print(f"  x={x_size}: tuned [{tp.backend} micro={tp.micro_batch}] "
              f"{tuned_ms:.4f}ms vs default [{dep_def.backend.name}] "
              f"{default_ms:.4f}ms (delta {row['delta_ms']:+.4f}ms, "
              f"searched {tp.searched}, pruned {tp.pruned})")
    ok = any(r["tuned_ms"] <= r["default_ms"] for r in rows)
    print(f"  tuned <= default for >=1 size: {ok}")
    if artifact:
        _write({"spec_k": k, "kind": "tune", "batch": max_batch,
                "rows": rows}, artifact, backend="tuned", device=device)
    return rows, ok


def check_against(baseline_path: str, *, artifact: str = ARTIFACT) -> list:
    """Raise ValueError (CLI: exit 2) when ``artifact`` and the baseline
    were recorded under different, or unrecorded, execution modes; return
    the soft mismatches (host/backend) otherwise."""
    current = json.loads(Path(artifact).read_text())
    baseline = json.loads(Path(baseline_path).read_text())
    perfstamp.check_comparable(current, baseline,
                               what=f"{artifact} vs {baseline_path}")
    soft = perfstamp.mismatches(current, baseline)
    for m in soft:
        print(f"  warning: {m}")
    return soft


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sizes", default="64,128,256,400")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--compare", action="store_true",
                    help="time fused vs per_pass vs xla")
    ap.add_argument("--tune", action="store_true",
                    help="autotune per size and record tuned-vs-default "
                         "frame-time deltas")
    ap.add_argument("--tune-iters", type=int, default=3,
                    help="timing repeats per tuner candidate")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="--tune serving batch / tuner max_batch")
    ap.add_argument("--against", metavar="OLD.json",
                    help="after the run, check the written artifact is "
                         "comparable with OLD.json (exit 2 on an "
                         "execution-mode mismatch)")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.sizes.split(","))
    common = dict(k=args.k, n=args.n, device=args.device)
    if args.tune:
        _, ok = run_tune(sizes, max_batch=args.max_batch,
                         iters=args.tune_iters, **common)
        if not ok:
            raise SystemExit(1)
    elif args.compare:
        _, ok = run_compare(sizes, **common)
        if not ok:
            raise SystemExit(1)
    else:
        run(sizes, **common)
    if args.against:
        try:
            check_against(args.against)
        except ValueError as e:
            print(f"  REFUSED: {e}")
            raise SystemExit(2)


if __name__ == "__main__":
    main()
