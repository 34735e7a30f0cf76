"""Paper Figure 3 on the card: sustained inference over many consecutive
frames (port of the reference's ``benchmarks/sustained.py``).

Reports per-frame time and its drift over a long run of edge encodes:
mean, p99, drift (the last quarter's mean against the first quarter's)
and the coefficient of variation.  Each frame is timed on the host clock
around a ``torch.cuda.synchronize()`` (on the CPU the call returns when
the work is done).

Execution paths come from :mod:`repro_torch.deploy`: every condition is
one :class:`DeploymentConfig` resolved by ``Deployment.build`` on
``--device`` (``cuda`` by default).  ``--manifest DEPLOY.json`` sustains
the manifest's own build (its tuned backend included).  Without one, the
pair is the ``fused`` kernel build (K1, one launch a frame) and the eager
``xla`` build of ``standard(k=4, c_in=4, h=--size)``, each keyed by its
backend name.  The reference's pair is its jit-compiled and its eager
``xla`` path; the port has no ``jax.jit``, and its kernel build takes the
compiled path's place.

    python -m repro_torch.benchmarks.sustained [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import perfstamp
from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.serving.server import _block

WARMUP = 3     # untimed frames before the clock starts


def sustained(fn, x, n_frames: int, *, warmup: int = WARMUP) -> np.ndarray:
    """Seconds per frame of ``n_frames`` synced calls of ``fn(x)``, after
    ``warmup`` untimed ones."""
    for _ in range(warmup):
        _block(fn(x))
    ts = np.empty(n_frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        _block(fn(x))
        ts[i] = time.perf_counter() - t0
    return ts


def _edge_fn(dep: Deployment, *, seed: int = 0):
    """The encoder (edge half) of a deployment, on its device."""
    edge_params = dep.init(torch.Generator().manual_seed(seed))["edge"]

    def fn(x):
        with torch.inference_mode():
            return dep.split.edge_apply(edge_params, x)
    return fn


def run(*, n_frames: int = 200, x_size: int = 128, k: int = 4,
        manifest: str | None = None, device=None) -> dict:
    """Sustain each condition for ``n_frames`` frames; returns
    ``{name: stamped stats}``."""
    if manifest is not None:
        with open(manifest) as f:
            cfg = DeploymentConfig.from_dict(json.load(f))
        dep = Deployment.build(cfg, device=device)
        x_size = cfg.in_h
        label = dep.backend.name
        if cfg.tuning is not None and cfg.tuning.measured_by_port:
            label += f"[tuned micro_batch={cfg.tuning.micro_batch}]"
        conditions = ((label, dep, n_frames),)
        for line in dep.build_log:
            print(f"  {line}")
    else:
        base = DeploymentConfig.standard(k=k, c_in=4, h=x_size)
        conditions = tuple(
            (backend, Deployment.build(dataclasses.replace(
                base, backend=backend), device=device), n_frames)
            for backend in ("fused", "xla"))
    first = conditions[0][1]
    c_in = first.config.spec.layers[0].c_in
    x = torch.rand((1, x_size, x_size, c_in),
                   generator=torch.Generator().manual_seed(1))
    x = x.to(first.device)

    out = {}
    for name, dep, n in conditions:
        ts = sustained(_edge_fn(dep), x, n)
        head, tail = ts[: n // 4].mean(), ts[-n // 4:].mean()
        out[name] = perfstamp.stamp({
            "mean_ms": ts.mean() * 1e3, "p99_ms":
                float(np.percentile(ts, 99) * 1e3),
            "drift_pct": 100.0 * (tail - head) / head,
            "cv_pct": 100.0 * ts.std() / ts.mean(),
            "n_frames": n,
        }, backend=dep.backend.name, device=dep.device)
        print(f"  {name:<9} {n} frames on {dep.device}: "
              f"mean={out[name]['mean_ms']:.4f}ms "
              f"p99={out[name]['p99_ms']:.4f}ms "
              f"drift={out[name]['drift_pct']:+.2f}% "
              f"cv={out[name]['cv_pct']:.2f}% "
              f"[{out[name]['mode']}]")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--manifest", metavar="DEPLOY.json",
                    help="sustain this deployment manifest's build (its "
                         "tuned backend honoured) instead of the "
                         "fused/xla default pair")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    run(n_frames=args.frames, x_size=args.size, manifest=args.manifest,
        device=args.device)


if __name__ == "__main__":
    main()
