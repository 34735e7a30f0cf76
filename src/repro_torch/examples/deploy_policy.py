"""The declarative deployment flow, end to end, in one page (port of the
reference's ``examples/deploy_policy.py``):

  manifest (DeploymentConfig)  ->  Deployment.build  ->  served policy

Builds the paper's standard split policy from ONE frozen config, ships it
through JSON (what would travel to the device, like the paper's compiled
shader bundles), drives the resolved pipeline (edge encode -> wire
payload -> micro-batched server -> actions), sizes a fleet with the
simulator on the measured t(B) curve, and ends with the manifest's real
fleet: worker processes serving over localhost sockets.

    python -m repro_torch.examples.deploy_policy [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.deploy import Deployment, DeploymentConfig
from repro_torch.serving.netsim import shaped


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    # ---- 1. declare the deployment ----------------------------------------
    cfg = DeploymentConfig.standard(
        k=4, c_in=12, h=84,          # the paper's K=4 encoder at task scale
        backend="fused",             # the whole PassPlan as ONE kernel (K1)
        codec="uint8",               # the paper's wire format
        max_batch=8,                 # server micro-batching policy
    )
    print("manifest:")
    print(cfg.to_json(indent=2))

    # ---- 2. ship the manifest (JSON round-trip) ---------------------------
    shipped = DeploymentConfig.from_json(cfg.to_json())
    if shipped != cfg:
        raise SystemExit("the manifest does not survive its JSON round-trip")

    # ---- 3. build it ------------------------------------------------------
    dep = Deployment.build(shipped, device=args.device)
    print(f"\nbackend={dep.backend.name} on {dep.device}: "
          f"{dep.backend.description}")
    print(f"plan: {dep.plan.total_passes} shader passes -> "
          f"feature {dep.plan.feature_shape}, {dep.wire_bytes} B on the "
          f"wire (raw frame {dep.frame_bytes} B)")
    print(f"one wave of K4's resident blocks on the card: "
          f"B <= {dep.max_safe_batch} frames (max_safe_batch; larger "
          f"batches stream through the persistent kernel; configured "
          f"max_batch={dep.config.max_batch})")

    # ---- 4. serve it ------------------------------------------------------
    params = dep.init(torch.Generator().manual_seed(0))
    client, server = dep.serving_pair(params)

    obs = torch.rand((3, 84, 84, 12),
                     generator=torch.Generator().manual_seed(1))
    obs = obs.to(dep.device)
    payloads = [client.encode_fn(obs[i:i + 1]) for i in range(3)]
    actions = server.serve(payloads)      # ONE batched call for 3 clients
    print(f"\nserved {len(actions)} queued requests in one micro-batch; "
          f"each action/feature vector: {tuple(actions[0].shape)}")

    # the served result equals the monolithic forward pass
    with torch.inference_mode():
        ref = dep.encoder.apply(params, obs)
    err = float((torch.stack(actions) - ref).abs().max())
    print(f"max |served - monolithic| = {err:.2e} "
          f"(uint8 wire quantisation)")
    if not err < 0.05:
        raise SystemExit(f"served actions off the monolith by {err}")

    # ---- 5. size the fleet ------------------------------------------------
    # the same manifest drives capacity planning: n_servers sharded
    # micro-batching servers behind a routing policy, each charging the
    # measured t(B) curve of THIS device's server
    bsrv = dep.server(params)
    bsrv.measure(payloads[0], batch_sizes=(1, 2, 4, 8), iters=3)
    model = bsrv.service_model()
    fleet_sim = dep.fleet_sim(model, uplink=shaped(1000), horizon_s=2.0)
    n_target = 500
    need = fleet_sim.min_servers(n_target, p95_budget_s=0.1,
                                 n_servers_max=16)
    one = fleet_sim.with_servers(1).max_clients(n_max=1024)
    if need:
        print(f"\nfleet sizing ({fleet_sim.router}): {need} server(s) keep "
              f"{n_target} clients @ 10 Hz under p95 < 100 ms "
              f"(1 server supports {one})")
    else:            # min_servers returns 0 when no fleet size suffices
        print(f"\nfleet sizing ({fleet_sim.router}): even 16 servers "
              f"cannot keep {n_target} clients under p95 < 100 ms "
              f"(1 server supports {one})")

    # ---- 6. run the fleet for real ----------------------------------------
    # the manifest's fleet shape as worker processes on this device: each
    # rebuilds the server half from the manifest, and the actions that
    # come back over the sockets equal in-process serving bit for bit
    want = [server.serve([p])[0].cpu().numpy() for p in payloads]
    fleet = dep.fleet(params, service_model=model)
    try:
        got = [fleet.request(p, client=i) for i, p in enumerate(payloads)]
        per_server = list(fleet.stats["per_server"])
    finally:
        leaked = fleet.close()
    bitwise = all(np.array_equal(w, g) for w, g in zip(want, got))
    print(f"\nreal fleet: {dep.config.n_servers} worker process(es) on "
          f"{dep.device} served {len(got)} requests over localhost "
          f"sockets (per-server {per_server}); bitwise equal to "
          f"in-process serving: {bitwise}; leaked workers: {leaked}")
    if not bitwise or leaked:
        raise SystemExit("the real fleet disagrees with in-process serving "
                         "or leaked a worker")

    print("\ndone: one manifest -> plan, kernels, codec, client, server, "
          "fleet plan, real fleet.")
    return {"max_abs_err": err, "min_servers": need, "one_server": one,
            "bitwise": bitwise, "leaked": leaked}


if __name__ == "__main__":
    main()
