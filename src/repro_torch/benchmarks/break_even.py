"""Paper §4.2: the break-even bandwidth equation, validated against the
simulated pipeline (port of the reference's ``benchmarks/break_even.py``).

  B* = 32 X^2 (1 - K/(4*2^(2n))) / j

Checks (a) the paper's Pi-Zero number (~50.4 Mb/s), (b) that the link
simulator's crossover lands at the predicted B* for a sweep of
configurations, and (c) the pod-boundary generalisation for two of the
repo's LLM configurations (``repro_torch.configs.ARCHS``).

``--manifest DEPLOY.json`` derives the :class:`SplitConfig` from a
deployment manifest instead: X and the stride-2 count come from the
manifest's spec, and the encode time ``j`` is MEASURED on ``--device``
(``cuda`` by default) from the built deployment's edge path (its tuning
block honoured), on the host clock with a device synchronize on both
sides of each call.  The answer is the bandwidth at which THIS deployment
stops paying for itself.

    python -m repro_torch.benchmarks.break_even --manifest build/m.json
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.latency import (PodSplitConfig, SplitConfig,
                                      break_even_bandwidth,
                                      paper_pi_zero_config,
                                      pod_break_even_bandwidth)
from repro_torch.device import DeviceLike
from repro_torch.serving.client import DecisionLoop
from repro_torch.serving.netsim import ShapedLink
from repro_torch.serving.server import _block


def crossover_mbps(cfg: SplitConfig, *, lo=1e5, hi=1e10) -> float:
    """Bisection on the simulated pipelines for the latency crossover."""
    def diff(bps):
        link = lambda: ShapedLink(bandwidth_bps=bps, propagation_s=0.0)
        so = DecisionLoop(link=link(), server_time_s=0.0, split=False,
                          payload_bytes=cfg.frame_bytes, action_bytes=0)
        sp = DecisionLoop(link=link(), server_time_s=0.0, split=True,
                          edge_time_s=cfg.encode_time_s,
                          payload_bytes=cfg.feature_bytes, action_bytes=0)
        return sp.decision_latency() - so.decision_latency()
    for _ in range(80):
        mid = (lo + hi) / 2
        if diff(mid) < 0:
            lo = mid
        else:
            hi = mid
    return mid / 1e6


def split_config_from_manifest(path: str, *, encode_time_s=None,
                               n_time: int = 16, device: DeviceLike = None):
    """SplitConfig for a deployment manifest: geometry from the spec,
    encode time the median of ``n_time`` synced calls of the built
    deployment's edge path on ``device``."""
    from repro_torch.deploy import Deployment, DeploymentConfig

    with open(path) as f:
        cfg = DeploymentConfig.from_dict(json.load(f))
    dep = Deployment.build(cfg, device=device)
    if encode_time_s is None:
        edge_params = dep.init(torch.Generator().manual_seed(0))["edge"]
        c_in = cfg.spec.layers[0].c_in
        x = torch.rand((1, cfg.in_h, cfg.in_w, c_in),
                       generator=torch.Generator().manual_seed(1)
                       ).to(dep.device)

        def fn(xx):
            with torch.inference_mode():
                return dep.split.edge_apply(edge_params, xx)

        for _ in range(3):
            fn(x)
        _block()
        ts = []
        for _ in range(n_time):
            t0 = time.perf_counter()
            fn(x)
            _block()
            ts.append(time.perf_counter() - t0)
        encode_time_s = float(np.median(ts))
    n_stride2 = sum(1 for layer in cfg.spec.layers if layer.stride == 2)
    return SplitConfig(x_size=cfg.in_h, n_stride2=n_stride2,
                       k_channels=cfg.spec.layers[-1].c_out,
                       encode_time_s=encode_time_s), dep


def run_manifest(path: str, *, device: DeviceLike = None):
    cfg, dep = split_config_from_manifest(path, device=device)
    pred = break_even_bandwidth(cfg) / 1e6
    sim = crossover_mbps(cfg)
    print(f"  manifest {path} [{dep.backend.name} on {dep.device}]: "
          f"X={cfg.x_size} n={cfg.n_stride2} K={cfg.k_channels} "
          f"j={cfg.encode_time_s * 1e3:.4f}ms (measured)")
    print(f"  predicted B*={pred:.2f} Mb/s, simulated crossover="
          f"{sim:.2f} Mb/s")
    assert abs(pred - sim) / pred < 0.02, \
        "equation disagrees with simulation"
    return {"config": path, "pred": pred, "sim": sim,
            "encode_time_s": cfg.encode_time_s}


def run():
    paper = paper_pi_zero_config()
    b_star = break_even_bandwidth(paper) / 1e6
    sim = crossover_mbps(paper)
    print(f"  paper config: predicted B*={b_star:.1f} Mb/s "
          f"(paper: 50.4), simulated crossover={sim:.1f} Mb/s")
    rows = [{"config": "paper", "pred": b_star, "sim": sim}]
    for x, n, k, j in ((256, 2, 4, 0.05), (512, 3, 16, 0.2),
                       (84, 3, 4, 0.01)):
        cfg = SplitConfig(x, n, k, j)
        p = break_even_bandwidth(cfg) / 1e6
        s = crossover_mbps(cfg)
        rows.append({"config": f"X{x}n{n}K{k}", "pred": p, "sim": s})
        print(f"  X={x} n={n} K={k} j={j}: predicted {p:.1f} "
              f"simulated {s:.1f} Mb/s")
        assert abs(p - s) / p < 0.02, "equation disagrees with simulation"

    # pod-boundary generalisation: int8 wire on the hidden state vs bf16
    print("  pod-boundary break-even (edge stage = 1/4 of layers, "
          "int8 wire vs bf16 baseline):")
    for arch_id in ("llama3-8b", "qwen3-0.6b"):
        cfg = ARCHS[arch_id]
        hidden = 32 * 1024 * cfg.d_model * 4        # (B=32, S=1k) fp32
        pod = PodSplitConfig(hidden_bytes_full=hidden, wire_itemsize=1.0,
                             edge_time_s=0.004,
                             raw_bytes=hidden // 2)  # bf16 baseline
        print(f"    {arch_id:<12} B*={pod_break_even_bandwidth(pod)/1e9:.1f}"
              f" Gb/s (DCN-relevant)")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--manifest", metavar="DEPLOY.json",
                    help="derive the split config (and measure j) from "
                         "this deployment manifest instead of the paper "
                         "constants sweep")
    ap.add_argument("--device", default="cuda",
                    help="where --manifest's j is measured: cuda (default) "
                         "or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.manifest:
        run_manifest(args.manifest, device=args.device)
    else:
        run()


if __name__ == "__main__":
    main()
