"""Quickstart: the MiniConv library and the split-policy pipeline (port of
the reference's ``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Spec -> split policy -> payload bytes -> break-even bandwidth against the
paper's 50.4 Mb/s.  Runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.latency import SplitConfig, break_even_bandwidth
from repro_torch.core.miniconv import (PI_ZERO_BUDGET, miniconv_apply,
                                       miniconv_init, standard_spec)
from repro_torch.core.split import make_split_policy
from repro_torch.core.wire import frame_bytes_rgba
from repro_torch.device import resolve_device


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A MiniConv encoder within the paper's Pi-Zero shader budget: <= 8
    #    bound textures, <= 64 texture samples per output pixel, 4 output
    #    channels per pass.
    spec = standard_spec(c_in=12, k=4)     # 3 stacked RGBA frames -> K=4
    spec.validate()                        # raises if any pass violates
    print(f"encoder: {len(spec.layers)} layers, {spec.total_passes} shader "
          f"passes, K={spec.k_out}, n_stride2={spec.n_stride2}")
    for i, l in enumerate(spec.layers):
        print(f"  layer {i}: {l.kernel}x{l.kernel} s{l.stride} "
              f"{l.c_in}->{l.c_out} "
              f"({PI_ZERO_BUDGET.samples(l.kernel, l.c_in)}"
              f"/{PI_ZERO_BUDGET.max_samples} samples/px)")

    # 2. Split policy: encoder on the edge, head on the server, uint8 wire.
    params = miniconv_init(torch.Generator().manual_seed(0), spec,
                           device=dev)
    fh, fw, k = spec.plan(84, 84).feature_shape
    head = (torch.randn((fh * fw * k, 3),
                        generator=torch.Generator().manual_seed(1))
            * 0.1).to(dev)
    policy = make_split_policy(
        lambda p, obs: miniconv_apply(p, spec, obs),
        lambda p, feats: feats.reshape(feats.shape[0], -1) @ p,
        codec="uint8")
    obs = torch.rand((1, 84, 84, 12),
                     generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.inference_mode():
        payload = policy.edge_step(params, obs)        # runs on the edge
        action = policy.server_step(head, payload)     # runs on the server
    print(f"\nobs {tuple(obs.shape)} -> wire "
          f"{policy.wire_bytes((1, fh, fw, k))} bytes (raw frame: "
          f"{frame_bytes_rgba(84) * 3} bytes) -> action "
          f"{tuple(action.shape)} on {dev}")

    # 3. The paper's break-even equation: below B*, split wins.
    cfg = SplitConfig(x_size=400, n_stride2=spec.n_stride2, k_channels=4,
                      encode_time_s=0.1)
    b_star = break_even_bandwidth(cfg) / 1e6
    print(f"\nbreak-even bandwidth (Pi-Zero config): {b_star:.1f} Mb/s "
          f"(paper: ~50.4)")
    return b_star


if __name__ == "__main__":
    main()
