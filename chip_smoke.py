#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card at the shapes the
served path gives it (and the fused kernel against the per-pass one),
times each, then serves split-policy decisions from a deployment manifest
through the port's entry points (``fused``, ``fused+head`` and
``reference`` backends), counting kernel launches, and checks the actions
against the eager ``xla`` build of the same manifest.

Any failure ends the run with a non-zero exit code and no result line.
On success the line before the last is ``{"kernels": [...]}`` (one entry
per kernel: launches on the served path, error, times and bound), and the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the checkout, it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bound.
PEAK_BYTES_S = 3.35e12        # HBM3
PEAK_FP32_FLOP_S = 67e12      # fp32 on the CUDA cores
FEAT_TOL = 1e-5   # fp32 features: the kernel sums in another order
Z_TOL = 1e-4      # projection: 484-term sums in another order
ACT_TOL = 1e-3    # served actions: a uint8 code may flip by one at .5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after ``warmup`` (inputs stay L2-resident, as on the served path)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    fp32 operations over the CUDA-core rate."""
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.core.miniconv import (LayerSpec, MiniConvSpec,
                                           miniconv_apply, miniconv_init,
                                           standard_spec)
    from repro_torch.deploy import Deployment, DeploymentConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.miniconv_pass import (miniconv_encoder,
                                                   miniconv_pass)
    from repro_torch.kernels.ops import same_pad
    from repro_torch.kernels.ref import (miniconv_encoder_ref,
                                         miniconv_pass_ref)
    from repro_torch.core.miniconv import _ACTS
    from repro_torch.rl.networks import (squashed_actor_init,
                                         squashed_actor_mode)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # cuDNN defaults to TF32 for fp32 convolutions, which would make the
    # plain version the inexact side of every comparison.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(built) or 'nothing (cached)'}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def rand(shape, seed, scale=1.0):
        return (torch.rand(shape, generator=gen(seed)) * scale).to(dev)

    def randn(shape, seed, scale=1.0):
        return (torch.randn(shape, generator=gen(seed)) * scale).to(dev)

    def layer_params(spec, seed):
        p = miniconv_init(gen(seed), spec, device=dev)
        # non-zero biases so the bias path is checked too
        for i, l in enumerate(spec.layers):
            p[f"layer{i}"]["bias"] = randn((l.c_out,), seed + 100 + i, 0.1)
        ws = [p[f"layer{i}"]["kernel"] for i in range(len(spec.layers))]
        bs = [p[f"layer{i}"]["bias"] for i in range(len(spec.layers))]
        return p, ws, bs

    def library_chain(x, ws, bs, plan):
        """The cuDNN F.conv2d chain on NCHW inputs prepared beforehand: a
        yardstick only, never called by the port."""
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = [w.permute(3, 2, 0, 1).contiguous() for w in ws]

        def run():
            y = xn
            for l, w, b in zip(plan.layers, wn, bs):
                y = F.pad(y, (l.pad_left, l.pad_right, l.pad_top,
                              l.pad_bottom))
                y = _ACTS[l.activation](F.conv2d(y, w, b, stride=l.stride))
            return y
        return run

    # ---- 2. kernels against their plain versions ---------------------------
    std = standard_spec(c_in=12, k=4)
    odd = MiniConvSpec((LayerSpec(4, 2, 12, 16, "relu"),
                        LayerSpec(3, 2, 16, 16, "sigmoid"),
                        LayerSpec(3, 2, 16, 6, "linear")))
    cases = [  # (label, spec, B, H, W, head D, head act)
        ("served edge", std, 1, 84, 84, None, "relu"),
        ("batch", std, 8, 84, 84, None, "relu"),
        ("batch+head", std, 8, 84, 84, 512, "relu"),
        ("global workspace", standard_spec(c_in=4, k=4), 2, 400, 400,
         None, "relu"),
        ("odd", odd, 3, 85, 83, 200, "sigmoid"),
    ]
    k1_rows = {}
    for idx, (label, spec, B, H, W, D, act) in enumerate(cases):
        plan = spec.plan(H, W)
        _, ws, bs = layer_params(spec, 10 * idx)
        x = rand((B, H, W, spec.layers[0].c_in), 10 * idx + 1)
        hw = hb = None
        if D is not None:
            hw = randn((plan.flat_features, D), 10 * idx + 2, 0.05)
            hb = randn((D,), 10 * idx + 3, 0.1)
        out = miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb,
                               head_act=act)
        ref = miniconv_encoder_ref(x, ws, bs, plan, head_w=hw, head_b=hb,
                                   head_act=act)
        torch.cuda.synchronize()
        feats, z = (out if D is not None else (out, None))
        rfeats, rz = (ref if D is not None else (ref, None))
        check(feats.shape == rfeats.shape and torch.isfinite(feats).all(),
              f"K1 {label}: bad features {tuple(feats.shape)}")
        err = (feats - rfeats).abs().max().item()
        check(torch.allclose(feats, rfeats, atol=FEAT_TOL, rtol=FEAT_TOL),
              f"K1 {label}: features differ by {err} (tol {FEAT_TOL})")
        zerr = None
        if D is not None:
            zerr = (z - rz).abs().max().item()
            check(torch.allclose(z, rz, atol=Z_TOL, rtol=Z_TOL),
                  f"K1 {label}: z differs by {zerr} (tol {Z_TOL})")
        again = miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb,
                                 head_act=act)
        again = again if D is not None else (again, None)
        check(torch.equal(feats, again[0])
              and (D is None or torch.equal(z, again[1])),
              f"K1 {label}: two runs differ (must repeat bit for bit)")

        def kern():
            return miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb,
                                    head_act=act)

        def plain():
            return miniconv_encoder_ref(x, ws, bs, plan, head_w=hw,
                                        head_b=hb, head_act=act)
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        lib_ms = cuda_ms(library_chain(x, ws, bs, plan))
        flops = plan.flops_per_batch(B, plan.head(D) if D else None)
        b_ms, b_by = bound(nbytes(x, *ws, *bs, hw, hb, feats, z), flops)
        print(f"K1 miniconv_encoder {label} x={tuple(x.shape)} head={D} "
              f"staging={plan.staging} ({plan.smem_bytes} B/frame): "
              f"max_abs_err feats {err:.3g} (tol {FEAT_TOL})"
              + (f" z {zerr:.3g} (tol {Z_TOL})" if zerr is not None else "")
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        k1_rows[label] = dict(max_abs_err=max(err, zerr or 0.0), ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_ms,
                              shape=list(x.shape), head=D)
    check({cases[3][0]} == {l for l, s, B, H, W, *_ in cases
                            if s.plan(H, W).staging == "global"},
          "exactly the 400x400 case must use the global workspace")

    # K2 on each layer of the standard plan, at the served shape (1 frame)
    # and at a batch of 8; the inputs are the plain chain's layer inputs.
    plan = std.plan(84)
    p_std, ws, bs = layer_params(std, 77)
    k2_err, k2_rows = 0.0, {}
    for B in (1, 8):
        y = rand((B, 84, 84, 12), 78)
        launches = []
        for l, w, b in zip(plan.layers, ws, bs):
            xp = same_pad(y, l.kernel, l.stride)
            wp = F.pad(w, (0, (-l.c_out) % 4))
            bp = F.pad(b, (0, (-l.c_out) % 4))
            for g in range(0, wp.shape[-1], 4):
                wg, bg = wp[..., g:g + 4].contiguous(), bp[g:g + 4].clone()
                got = miniconv_pass(xp, wg, bg, stride=l.stride)
                want = miniconv_pass_ref(xp, wg, bg, stride=l.stride)
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                check(torch.allclose(got, want, atol=FEAT_TOL,
                                     rtol=FEAT_TOL),
                      f"K2 layer {l.index} group {g // 4} B={B}: differs "
                      f"by {e} (tol {FEAT_TOL})")
                k2_err = max(k2_err, e)
                launches.append((xp, wg, bg, l.stride, got))
            y = _ACTS[l.activation](miniconv_pass_ref(xp, w, b,
                                                      stride=l.stride))
        check(len(launches) == plan.total_passes == 9,
              f"K2: {len(launches)} passes, expected 9")
        lib_in = [(xp.permute(0, 3, 1, 2).contiguous(),
                   wg.permute(3, 2, 0, 1).contiguous(), bg, s)
                  for xp, wg, bg, s, _ in launches]
        ms = cuda_ms(lambda: [miniconv_pass(xp, wg, bg, stride=s)
                              for xp, wg, bg, s, _ in launches])
        plain_ms = cuda_ms(lambda: [miniconv_pass_ref(xp, wg, bg, stride=s)
                                    for xp, wg, bg, s, _ in launches])
        lib_ms = cuda_ms(lambda: [F.conv2d(xn, wn, bg, stride=s)
                                  for xn, wn, bg, s in lib_in])
        b_ms, b_by = bound(sum(nbytes(xp, wg, bg, out)
                               for xp, wg, bg, _, out in launches),
                           B * plan.flops_per_frame)
        print(f"K2 miniconv_pass: the 9 passes of the standard 84x84 plan "
              f"at B={B}: max_abs_err {k2_err:.3g} (tol {FEAT_TOL}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}) for 9 launches")
        k2_rows[B] = dict(max_abs_err=k2_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          shape=[B, 84, 84, 12])

    # One hand kernel against the other: the per-pass tier against the
    # fused tier, both on the card.
    xb = rand((8, 84, 84, 12), 79)
    per_pass = miniconv_apply(p_std, std, xb, use_kernel="reference")
    fused = miniconv_apply(p_std, std, xb, use_kernel="fused", plan=plan)
    torch.cuda.synchronize()
    e = (per_pass - fused).abs().max().item()
    check(torch.allclose(per_pass, fused, atol=FEAT_TOL, rtol=FEAT_TOL),
          f"reference tier vs fused tier differ by {e}")
    print(f"K2 chain (reference backend) vs K1 (fused) at (8,84,84,12): "
          f"max_abs_err {e:.3g} (tol {FEAT_TOL})")

    # ---- 3. serve: the fused main path -------------------------------------
    cfg = DeploymentConfig.standard(k=4, c_in=12, h=84, backend="fused",
                                    max_batch=8)
    dep = Deployment.build(cfg)
    check(dep.device.type == "cuda", f"built on {dep.device}, not cuda")
    for line in dep.build_log:
        print(f"build_log: {line}")
    params = dep.init(gen(0))
    hp = squashed_actor_init(gen(1), cfg.head_dim, 6, device=dev)

    def head(z):
        return squashed_actor_mode(hp, z)

    obs = rand((8, 84, 84, 12), 2)
    client, server = dep.serving_pair(params, head)
    miniconv_encoder.launches = miniconv_pass.launches = 0
    payloads = [client.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions = torch.stack(server.serve(payloads))
    torch.cuda.synchronize()
    fused_launches = miniconv_encoder.launches
    check(fused_launches == 8 and miniconv_pass.launches == 0,
          f"fused serve launched K1 {fused_launches} and K2 "
          f"{miniconv_pass.launches} times; expected 8 and 0")
    check(actions.shape == (8, 6) and torch.isfinite(actions).all(),
          f"bad actions {tuple(actions.shape)}")
    check(payloads[0]["data"].dtype == torch.uint8
          and tuple(payloads[0]["data"].shape) == (1, 11, 11, 4)
          and dep.wire_bytes == 492, "payload is not (1,11,11,4) uint8 "
          "with an 8-byte header")

    dep_x = Deployment.build(dataclasses.replace(cfg, backend="xla"))
    client_x, server_x = dep_x.serving_pair(params, head)
    payloads_x = [client_x.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions_x = torch.stack(server_x.serve(payloads_x))
    code_diff = max((p["data"].int() - q["data"].int()).abs().max().item()
                    for p, q in zip(payloads, payloads_x))
    act_err = (actions - actions_x).abs().max().item()
    check(code_diff <= 1, f"fused vs xla payload codes differ by "
          f"{code_diff} (> 1)")
    check(act_err <= ACT_TOL, f"fused vs xla actions differ by {act_err}")
    with torch.inference_mode():
        float_actions = head(dep_x.encoder.apply(params, obs))
    q_err = (actions - float_actions).abs().max().item()
    check(q_err <= 5e-2, f"served actions off the float policy by {q_err}")
    print(f"serve fused: 8 requests, K1 launches {fused_launches}; actions "
          f"vs xla build max_abs_err {act_err:.3g} (tol {ACT_TOL}), "
          f"payload codes within {code_diff}, vs float policy {q_err:.3g}")
    edge_s = client.measure(obs[0:1], iters=50)
    t8 = server.measure(payloads[0], batch_sizes=(8,), iters=50)[8]
    edge_x = client_x.measure(obs[0:1], iters=50)
    print(f"serve fused: edge {edge_s * 1e3:.4f} ms/frame (xla build "
          f"{edge_x * 1e3:.4f} ms/frame), server {t8 * 1e3:.4f} ms per "
          f"8-request batch (host clock around synchronize)")

    # ---- 4. fused+head and reference paths ---------------------------------
    dep_h = Deployment.build(dataclasses.replace(cfg, backend="fused+head"))
    miniconv_encoder.launches = miniconv_pass.launches = 0
    with torch.inference_mode():
        z_h = dep_h.encoder.apply(params, obs)
        torch.cuda.synchronize()
        z_x = dep_x.encoder.apply(params, obs)
    check(miniconv_encoder.launches == 1 and miniconv_pass.launches == 0,
          f"fused+head launched K1 {miniconv_encoder.launches} times for "
          f"one batch; expected 1")
    zerr = (z_h - z_x).abs().max().item()
    check(torch.allclose(z_h, z_x, atol=Z_TOL, rtol=Z_TOL),
          f"fused+head vs xla z differ by {zerr}")
    print(f"fused+head: encoder.apply on 8 frames, K1 launches 1; z vs xla "
          f"max_abs_err {zerr:.3g} (tol {Z_TOL})")

    dep_r = Deployment.build(dataclasses.replace(cfg, backend="reference"))
    client_r, server_r = dep_r.serving_pair(params, head)
    miniconv_encoder.launches = miniconv_pass.launches = 0
    payload_r = client_r.encode_fn(obs[0:1])
    action_r = server_r.serve([payload_r])[0]
    torch.cuda.synchronize()
    ref_launches = miniconv_pass.launches
    check(ref_launches == 9 and miniconv_encoder.launches == 0,
          f"reference serve launched K2 {ref_launches} and K1 "
          f"{miniconv_encoder.launches} times; expected 9 and 0")
    r_err = (action_r - actions[0]).abs().max().item()
    check(r_err <= ACT_TOL, f"reference vs fused action differ by {r_err}")
    print(f"serve reference: 1 request, K2 launches {ref_launches}; action "
          f"vs fused max_abs_err {r_err:.3g} (tol {ACT_TOL})")

    # ---- 5. results --------------------------------------------------------
    k1 = k1_rows["served edge"]
    k2 = k2_rows[1]
    kernels = [
        dict(name="miniconv_encoder", route="cuda",
             source="src/repro_torch/kernels/csrc/miniconv_encoder.cu",
             replaces="src/repro/kernels/miniconv_pass.py:267",
             launches=fused_launches, **k1),
        dict(name="miniconv_pass", route="cuda",
             source="src/repro_torch/kernels/csrc/miniconv_pass.cu",
             replaces="src/repro/kernels/miniconv_pass.py:91",
             launches=ref_launches, **k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
