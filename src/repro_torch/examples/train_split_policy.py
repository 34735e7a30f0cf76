"""End to end, the paper's kind (port of the reference's
``examples/train_split_policy.py``): train a split visual policy with RL,
then DEPLOY it split and measure decision latency under bandwidth
shaping — learning + the Figure 5 pipeline in one script.

    python -m repro_torch.examples.train_split_policy \\
        --task pendulum --encoder miniconv4 --steps 2048 [--device cpu]

Trains on the GPU unless ``--device cpu`` is given, and serves the trained
parameters from a manifest on the ``fused`` backend: the encoder is one
K1 launch a frame (the reference serves on ``xla``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.device import resolve_device
from repro_torch.envs import make_pixel_env
from repro_torch.rl.agent import make_agent
from repro_torch.rl.train import train
from repro_torch.serving.client import DecisionLoop
from repro_torch.serving.netsim import shaped
from repro_torch.serving.server import PolicyServer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", default="pendulum",
                    choices=["pendulum", "hopper", "walker"])
    ap.add_argument("--encoder", default="miniconv4",
                    choices=["miniconv4", "miniconv16", "full_cnn"])
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. learn (paper §4.1, smoke scale) ------------------------------
    print(f"training {args.encoder} on {args.task} "
          f"({args.steps} env steps) on {dev}...")
    result = train(args.task, args.encoder, total_steps=args.steps,
                   device=dev)
    s = result.summary()
    print(f"  best={result.best:.1f} mean={result.mean:.1f} "
          f"final={result.final:.1f} over {s['episodes']} episodes "
          f"({s['episodes_truncated']} truncated) at "
          f"{result.steps_per_sec:.1f} env-steps/s")

    if not args.encoder.startswith("miniconv"):
        print("full_cnn has no split deployment; done.")
        return {"summary": s}

    # ---- 2. deploy split (paper §4.3) -------------------------------------
    # ONE declarative config resolves the spec, plan, codec and both
    # serving halves; the same manifest could ship to the device as JSON.
    cfg = DeploymentConfig.from_encoder_name(args.encoder, c_in=9, h=84,
                                             backend="fused")
    dep = Deployment.build(cfg, device=dev)
    env = make_pixel_env(args.task, train=False)
    _, obs = env.reset_batch(torch.Generator(device=dev).manual_seed(1), 1)

    # serve the TRAINED parameters straight from the manifest: the
    # Deployment accepts TrainResult.params (its "encoder" entry is the
    # edge/server split), and the agent's policy_head is the served head
    agent = make_agent(result.algo, dep.encoder, env.action_dim, device=dev)
    client = dep.client(result.params)
    server_fn = dep.server_fn(result.params,
                              head=agent.policy_head(result.params))

    j = client.measure(obs)
    srv = PolicyServer(server_fn).measure(client.encode_fn(obs))
    frame_bytes = dep.frame_bytes

    print(f"\ndeployment ({dep.backend.name} on {dep.device}): edge "
          f"{j*1e3:.2f} ms, wire {client.wire_bytes} B (raw {frame_bytes} B)")
    print(f"{'Mb/s':>6} {'server-only(ms)':>16} {'split(ms)':>10}")
    rows = []
    for mbps in (10, 25, 50, 100):
        so = DecisionLoop(link=shaped(mbps), server_time_s=srv,
                          split=False, payload_bytes=frame_bytes)
        sp = DecisionLoop(link=shaped(mbps), server_time_s=srv,
                          split=True, edge_time_s=j,
                          payload_bytes=client.wire_bytes)
        row = (mbps, so.median_latency(100) * 1e3,
               sp.median_latency(100) * 1e3)
        rows.append(row)
        print(f"{row[0]:>6} {row[1]:>16.1f} {row[2]:>10.1f}")
    return {"summary": s, "edge_s": j, "server_s": srv, "rows": rows,
            "wire_bytes": client.wire_bytes, "frame_bytes": frame_bytes}


if __name__ == "__main__":
    main()
