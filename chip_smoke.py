#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (K1
the fused encoder, K2 the per-pass kernel and K3 the grouped layer, one
tiled layer kernel whose ptxas register and spill report it prints, K4
the streamed encoder, K5 flash attention, whose bf16 route must show
HGMMA instructions in its SASS), holds each against its plain PyTorch version
on the card at the shapes the served paths give it (and the tiers
against each other), times each, then drives the port's entry
points: it serves split-policy decisions from a deployment manifest
(``fused``, ``fused+head``, ``reference`` and ``grouped`` backends), tunes
the manifest on the card with ``python -m repro_torch.deploy --tune`` and
serves through the tuned build, encodes 64 frames of 400x400x4 through
``fused+stream``, serves one split decision of Qwen3-0.6B at full
width (random weights from a seed) through ``repro_torch.launch.serve``,
and runs the paper's latency path on the tuned manifest: Table 5
(``benchmarks.decision_latency``: split below server-only at 10 Mb/s, the
edge kernel launched), Table 6 and the fleet table on the card's measured
t(B) curve (``benchmarks.scalability``: the smoke and fleet-monotone
gates), the break-even bandwidth with the edge encode time measured on the
card (``benchmarks.break_even``), and the ``wifi_markov`` scenario twice,
bitwise equal.  Last it serves that manifest from worker processes on the
card over localhost sockets (``repro_torch.serving.realfleet``): 4
workers whose actions equal in-process serving bit for bit through every
router and after one is killed, the measured p95 against the fleet
simulator's at 1, 2 and 4 workers under every router and its gate, one
cell with shaped ingress, Table 5's real-fleet row, and the edge kernel
sustained for 2,000 frames.  Then it trains (``repro_torch.rl.train``):
one update of each algorithm and 50 steps of each env held against the
CPU, the paper's three pairings trained briefly on the card with the
host syncs inside a steady chunk and a PPO rollout counted (none
allowed) and a steady chunk traced, and the trained DDPG and SAC
policies served from a ``fused`` manifest through K1 at 9 input
channels, against the ``xla`` build.  Last it trains populations
(``repro_torch.rl.population``): a 4-member DDPG population in exact and
in batched (``torch.func.vmap``) lanes, whose bitwise gates run in a child
process in deterministic mode (``python3 chip_smoke.py
--population-gates``, which the script starts itself), the winner served
through K1 by ``Deployment.export_best``, the aggregate throughput of
populations of 1, 4 and 16 members against as many sequential runs, a
traced chunk at 16 members, and ``benchmarks.learning --smoke``.
Last it runs the LM's decode path and training at Qwen3-0.6B's full width:
a 128-token prompt decoded one token at a time over a bf16 KV cache
against the K5 forward, 32 greedy tokens twice bit for bit, one step at a
32,768-deep cache at batch 1 and 8, decode and one ``Trainer`` step held
against the CPU (no K5 launch in a step: it has no backward pass), then
``python -m repro_torch.launch.train --full`` for 8 steps and a checkpoint
restored bit for bit.  Last it serves and decodes the MoE, Mamba-2 and
RG-LRU families at their published widths (qwen2-moe-a2.7b, 14 B
parameters, K5 on its 24 attention cores; mamba2-130m; recurrentgemma-9b):
one split decision each (the float32 codec's split bit for bit the
monolith), a 128-token prompt decoded into a bf16 cache against the
forward and 32 greedy tokens, each family's reduced config card against
CPU, K5 held at the MoE's shape, and ``launch.train --arch mamba2-130m
--full`` for 24 steps, past its 20-step warmup, until the loss falls,
with one step's gradients held against the CPU.  Last it runs Whisper's
encoder-decoder at whisper-medium's full width (``repro_torch.models.
whisper``): K5 held at the encoder's non-causal (1,16,1500,64) and the
decoder's ragged (1,16,448,64) shapes, 1,500 stub frames encoded through
24 K5 launches on the tensor cores, the teacher-forced decoder at 448
positions (24 more), 32 prompt tokens decoded over the self and cross
caches against it in bf16 and f32 and 32 greedy tokens twice bit for bit,
the reduced config card against CPU, ``launch.train --arch
whisper-medium --full`` for 24 steps, and llava-next-mistral-7b's prefill
at full width (2,880 stub patch embeddings and 128 text tokens, 32 K5
launches) with K5 held at its (1,32/8,3008,128) shape.  Last it runs
the sharded LM step: the dry-run of the production meshes at full width
in child processes (``python -m repro_torch.launch.dryrun`` for
qwen3-0.6b's four shapes, its multi-pod training step and
llama4-scout-17b-a16e's training step, and ``launch.perf``'s pair C,
rendered by ``benchmarks.roofline_table``), started before the LM
phases and run beside them, and Qwen3-0.6B's train, prefill and decode
steps as DTensor steps on a 1x1 nccl mesh at full width, each bitwise
against the unsharded model, its counted FLOPs and bytes equal to the
dry-run's of the same step (``python3 chip_smoke.py --sharded-dryrun
OUT``, a child), the prefill through K5 28 times.
Last it collects the port's static analysis (``python -m
repro_torch.analysis --strict``, a child started before phase 1), which
must exit 0, and holds the shared-memory budget its ``kernel-smem`` rule
audits (``passplan.SMEM_LIMIT``) against the card's opt-in shared memory
of one block.  Last it runs the dense decoders no earlier phase runs:
llama3-8b, qwen2.5-14b and minitron-8b uncut and llama4-scout-17b-a16e at
full width with 2 of its 48 layers, each with a split decision (K5 32,
48, 32 and 2 times, the float32 codec's split bit for bit the monolith)
and a 128-token prompt decoded against the forward, and Qwen3-0.6B's
long_500k decode: an 8,192-token prefill windowed at 4,096 (28 K5
launches), its K/V rows in a 524,288-deep bf16 cache, 32 greedy tokens
with the window scored over the whole cache and the same tokens with it
gathered, and one step at index 524,287 on each route.  Last it holds K7,
the grouped expert GEMM of granite-4.0-h's dropless MoE, against its
plain version and ``torch._grouped_mm`` at 72 experts and 81,920 routed
rows, and K5 at granite-4.0-h's (4, 32/8, 2,048, 128) attention with its
1/128 scale, then drives one decision of the benchmark cell
``granite4h.pf4x2048`` through the program's split path (granite-4.0-h
at full width, its first 20 layers: 4 prompts x 2,048 tokens, the edge's
10 layers, the uint8 codec, the server's 10 layers and the head at the
last position), whose K7 and K5 launches are K7's row in the
``kernels`` line, and holds K8, the chunked SSD scan of its Mamba-2
mixers, against its plain version at the cell's (4, 2,048, 128 x 64, N
128) bf16 views, its 18 launches in that decision K8's row (``python3
chip_smoke.py --granite`` runs this phase alone).
Each path runs with every launch count set to 0 just before it and read
just after; the actions are checked against the eager ``xla`` build of
the same manifest, and the LM's logits against its monolith and against
the CPU's plain versions.

Any failure ends the run with a non-zero exit code and no result line.
Phase 14 prints its numbers as a ``{"training": ...}`` line, phase 15 as
a ``{"population": ...}`` line, phase 16 as a ``{"lm": ...}`` line,
phase 17 as a ``{"families": ...}`` line, phase 18 as a ``{"whisper":
...}`` line, phase 19 as a ``{"sharded": ...}`` line, phase 20 as an
``{"analysis": ...}`` line, phase 21 as a ``{"dense": ...}`` line, phase
22 as a ``{"granite": ...}`` line.
On success the line before the last is ``{"kernels": [...]}`` (one entry
per kernel: launches on the served path, error, times and bound), and the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the rest of the checkout, it exits non-zero.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bound.
PEAK_BYTES_S = 3.35e12        # HBM3
PEAK_FP32_FLOP_S = 67e12      # fp32 on the CUDA cores
PEAK_BF16_FLOP_S = 989e12     # bf16 on the tensor cores, dense
FEAT_TOL = 1e-5   # fp32 features: the kernel sums in another order
Z_TOL = 1e-4      # projection: 484-term sums in another order
ACT_TOL = 1e-3    # served actions: a uint8 code may flip by one at .5
# PPO's 32-step update, card vs CPU: its losses are means over minibatches
# taken at parameters that drift apart by rounding through Adam.  Sound
# updates read 4.5e-6 to 1.05e-4, the two faults planted in the card's
# draws 4.3e-3 to 6.4e-3 (PERF.md, the training findings)
PPO_STEPS_RTOL = 3e-4
ATTN_TOL = {"float32": 2e-4,  # K5 in f32: sums in another order
            "bfloat16": 1e-2}  # K5 in bf16 vs plain f32: its output rounding
# K5 in bf16 on rows of a 32,768-key causal prefill against the plain f32
# rows, element by element: |K5 - plain| <= K5_ROWS_ATOL * RMS of the rows
# + K5_ROWS_RTOL * |plain|.  A late row's output is a mean over up to 32k
# values (RMS about 0.013 here), so a plain absolute limit is as large as
# the output.  Rounding the output to bf16 moves it by at most 2^-8 of
# itself (an early row, few keys: up to 4 in size), rounding P far less;
# a dropped 128-key tile moves a late row by over 3x the limit (the phase
# checks it)
K5_ROWS_RTOL = 2.0 ** -6
K5_ROWS_ATOL = 0.02
# K5 in bf16 against the plain f32 version on the rows of a windowed
# prefill whose window is full, as one block: ||K5 - plain|| <=
# K5_WINDOW_RTOL * ||plain||.  Such a row averages ``window`` values, so
# single elements near 0 carry the bf16 rounding of P at many times their
# size; rounding moves the block by about 2^-9, a dropped 128-key tile
# of a 4,096-key window by about 0.18 (the phase checks the latter
# at over 5x the limit)
K5_WINDOW_RTOL = 2.0 ** -6
LM_SPLIT_TOL = 1e-2   # full-width bf16 split (float32 codec) vs monolith
LM_CPU_TOL = {"reduced": 1e-4, "full width": 1e-3}  # card vs CPU, f32
# Device time a launch of the first-draft K2 and K3 (one thread an
# output, before the tiled layer kernel), traced on a served request by
# this script on an NVIDIA H100 80GB HBM3 at 700.00 W, printed beside
# this run's.
FIRST_K2_US, FIRST_K3_US = 16.60, 11.85


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


def bound(n_bytes, flops, peak_flop_s=PEAK_FP32_FLOP_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type (fp32 on the CUDA cores
    unless given)."""
    t_b, t_f = n_bytes / PEAK_BYTES_S, flops / peak_flop_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def profile_decision(fn):
    """Trace one call of ``fn`` (``lm_split.trace_decision``) and print the
    device's busy time, the kernels launched, the busy share of the traced
    call's wall time, K5's device time a launch and the top kernels.
    Returns (kernels launched, K5 device us a launch), or None when the
    profiler sees no device time."""
    from repro_torch.benchmarks.lm_split import trace_decision
    t = trace_decision(fn)
    busy_ms, wall_ms, n = t["busy_ms"], t["traced_wall_ms"], t["kernels"]
    if not n:
        print(f"profile: the profiler saw no device time; busy share not "
              f"measured (traced wall {wall_ms:.4f} ms)")
        return None
    k5_us = t["k5_device_us"] or 0.0
    print(f"profile of one split decision (edge + server): {n} kernels, "
          f"device busy {busy_ms:.4f} ms of {wall_ms:.4f} ms traced wall "
          f"({100 * busy_ms / wall_ms:.2f}%); K5 {k5_us:.2f} us of device "
          f"time a launch over {t['k5_launches']} launches; top: "
          + "; ".join(f"{key[:60]} x{count} {ms:.4f} ms"
                      for key, count, ms in t["top"]))
    return n, k5_us


def kernel_device_us(fn, name=None, calls=20):
    """(device time of one launch, launches a call) of the kernels whose
    name holds ``name`` (every kernel when None), from a torch.profiler
    trace of ``calls`` calls of ``fn``; None when the profiler sees no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and (name is None or name in e.key) and e.self_device_time_total]
    if not hits:
        return None
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / n, n / calls


def host_us(fn, calls=2000):
    """Host time of one call of ``fn`` in microseconds: ``calls`` calls
    without a synchronize between them, so where the device keeps up it is
    what the caller's thread spends a call."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def attention_pairs(S, window):
    """(query, key) pairs a causal row set sees: min(q + 1, window) each."""
    w = S if window is None else window
    return sum(min(q + 1, w) for q in range(S))


def rel_rows(got, want, first):
    """||got - want|| / ||want|| over the query rows from ``first`` on
    ((B, H, S, D) tensors, compared in f32)."""
    d = got[:, :, first:].float() - want[:, :, first:].float()
    return (d.norm() / want[:, :, first:].float().norm()).item()


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def layer_ptxas(log):
    """ptxas's report of ``miniconv_layer.cu``, one (kernel<kh, kw,
    stride, c_in, pix, cb>, registers, spill stores, spill loads) per
    instantiation (0 in the template arguments: the generic one)."""
    import re
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(pass_kernel|layer_grouped_kernel)I((?:Li\d+E)+)",
                          m.group(1))
            name = m.group(1)
            if k:
                targs = ",".join(re.findall(r"Li(\d+)E", k.group(2)))
                name = f"{k.group(1)}<{targs}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


class SyncCounter:
    """Counts the host synchronisations CUDA work makes while it is
    entered (``torch.cuda.set_sync_debug_mode("warn")``), and where each
    came from."""

    def __enter__(self):
        import warnings
        import torch
        self._w = warnings.catch_warnings(record=True)
        self.records = self._w.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)
        self._w.__exit__(*exc)
        # torch's words for a sync: "called a synchronizing CUDA
        # operation" (its notice that the mode is a prototype is not one)
        self.syncs = [f"{r.filename}:{r.lineno}: {r.message}"
                      for r in self.records
                      if "called a synchronizing" in str(r.message)]
        return False


# Phase 14 (b)'s off-policy train chunks, in vector steps: its train()
# runs plan their training in two chunks of it and the sync gate runs one
# more (rollout.CHUNK, 128, until phase 21 came: every gate holds at the
# shorter chunk, and the second chunk's rate is still steady)
TRAIN_CHUNK = 32


def train_chunks(n):
    """A context in which ``rl.rollout.offpolicy_plan`` (``train()``'s
    plan) cuts off-policy training into chunks of ``n`` vector steps."""
    import contextlib
    from repro_torch.rl import rollout

    @contextlib.contextmanager
    def chunks():
        was, rollout.CHUNK = rollout.CHUNK, n
        try:
            yield
        finally:
            rollout.CHUNK = was
    return chunks()


def training_phase(dev, gen, miniconv_encoder, reset_counts):
    """Phase 14: the RL training stack on the card.  (a) one update of
    each algorithm and 50 steps of each env, card against CPU; (b) each
    pairing trained through ``train(..., device="cuda")`` with its steady
    chunk's host syncs counted, and a traced steady chunk; (c) the trained
    DDPG and SAC policies served through K1.  Returns (the
    ``{"training": ...}`` dict, K1 launches on the serving path)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks.lm_split import trace_decision
    from repro_torch.deploy import Deployment, DeploymentConfig
    from repro_torch.envs import REGISTRY as ENVS
    from repro_torch.envs import make_pixel_env
    from repro_torch.envs.wrappers import crop
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.rl.agent import make_agent, move_state
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.ppo import PPOConfig
    from repro_torch.rl.rollout import offpolicy_chunk_fn, onpolicy_rollout
    from repro_torch.rl.sac import SACConfig
    from repro_torch.rl.train import TASK_ALGO, _pipeline_encoder
    from repro_torch.rl.train import train as rl_train

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    A = {"pendulum": 1, "hopper": 3, "walker": 6}
    CFG = {"ddpg": DDPGConfig(), "sac": SACConfig(), "ppo": PPOConfig()}
    out = {"tf32": {"cuda.matmul.allow_tf32":
                    torch.backends.cuda.matmul.allow_tf32,
                    "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}}
    print(f"training: TF32 in force: {out['tf32']}")

    # ---- (a) card against CPU ------------------------------------------
    def batch_for(algo, cfg, rng):
        a = A[{v: k for k, v in TASK_ALGO.items()}[algo]]
        if algo == "ppo":
            T, N = cfg.n_steps, cfg.n_envs
            return {"traj": {
                "obs": rng.random((T, N, 84, 84, 9), np.float32),
                "action": rng.standard_normal((T, N, a), np.float32),
                "reward": rng.standard_normal((T, N), np.float32),
                "done": rng.random((T, N)) < 0.02,
                "logp": rng.standard_normal((T, N), np.float32) - 5,
                "value": rng.standard_normal((T, N), np.float32)},
                "last_obs": rng.random((N, 84, 84, 9), np.float32)}
        B = cfg.batch_size
        return {"obs": rng.random((B, 84, 84, 9), np.float32),
                "next_obs": rng.random((B, 84, 84, 9), np.float32),
                "actions": rng.uniform(-1, 1, (B, a)).astype(np.float32),
                "rewards": rng.standard_normal(B, np.float32),
                "dones": (rng.random(B) < 0.3).astype(np.float32)}

    def card_vs_cpu(algo, cfg, seed, faults=None):
        """One update from the same state, batch and draws on the CPU and
        the card; ``faults`` maps a name to a change of the draws that
        the card's update then runs, to read what the gate sees of it."""
        a = A[{v: k for k, v in TASK_ALGO.items()}[algo]]
        agents = {d: make_agent(algo, _pipeline_encoder("miniconv4", 9,
                                                        device=d), a,
                                cfg=cfg, device=d) for d in ("cpu", "cuda")}
        state = agents["cpu"].init(gen(seed))
        data = tree_map(lambda x: torch.from_numpy(np.asarray(x)),
                        batch_for(algo, cfg, np.random.default_rng(seed)))
        noise = agents["cpu"].draw_noise(gen(seed + 1), data)

        def update(d, n):
            if isinstance(n, torch.Tensor):
                n = n.to(d)
            elif n is not None:
                n = tuple(x.to(d) for x in n)
            return agents[d].update(move_state(state, d),
                                    tree_map(lambda x: x.to(d), data),
                                    noise=n)

        (cs, cm), (gs, gm) = update("cpu", noise), update("cuda", noise)

        def loss_rel(m):
            # the smallest rtol under which |card - cpu| <= 1e-5 + rtol |cpu|
            # holds for every metric
            ex = [(max(abs(float(m[k]) - float(cm[k])) - 1e-5, 0.0),
                   abs(float(cm[k]))) for k in cm]
            return max(e / c if e else 0.0 for e, c in ex)

        steps = int(cs.opt_state.step)
        rtol = 1e-4 if steps == 1 else PPO_STEPS_RTOL
        loss_err = loss_rel(gm)
        grad_err = max(float((g.cpu() - w).abs().max())
                       / max(float(w.abs().max()), 1e-30) for w, g in
                       zip(tree_leaves(cs.opt_state.mu),
                           tree_leaves(gs.opt_state.mu)))
        param_err = max(float((g.cpu() - w).abs().max()) for w, g in
                        zip(tree_leaves(cs.params), tree_leaves(gs.params)))
        check(int(gs.opt_state.step) == steps, f"{algo}: Adam steps differ")
        check(loss_err <= rtol, f"{algo} card vs CPU: losses differ by "
              f"{loss_err:.3g} of the CPU's (tol 1e-5 + {rtol:g} |cpu|)")
        check(param_err <= 2 * cfg.lr * steps, f"{algo} card vs CPU: params "
              f"differ by {param_err:.3g} (tol 2 lr x {steps} steps)")
        if steps == 1:
            check(grad_err <= 1e-4, f"{algo} card vs CPU: gradients differ "
                  f"by {grad_err:.3g} of a leaf's largest (tol 1e-4)")
        planted = {}
        for name, change in (faults or {}).items():
            planted[name] = loss_rel(update("cuda", change(noise))[1])
            check(planted[name] > rtol, f"{algo}: the loss gate (rtol "
                  f"{rtol:g}) does not see a planted {name}: "
                  f"{planted[name]:.3g}")
        return dict(adam_steps=steps, loss_rtol=rtol, loss_rel_err=loss_err,
                    grad_rel_err=grad_err if steps == 1 else None,
                    param_abs_err=param_err, param_tol=2 * cfg.lr * steps,
                    planted_faults=planted)

    def dropped_minibatch(perms):
        # epoch 0 trains its first minibatch twice and skips its second
        mb = perms.shape[1] // CFG["ppo"].n_minibatches
        perms = perms.clone()
        perms[0, mb:2 * mb] = perms[0, :mb]
        return perms

    def swapped_epochs(perms):
        # epochs 0 and 1 run each other's permutation
        return perms[[1, 0, *range(2, perms.shape[0])]]

    t0 = time.perf_counter()
    upd = {}
    for algo in ("ddpg", "sac"):
        upd[algo] = card_vs_cpu(algo, CFG[algo], 40)
    # PPO's 32 Adam steps on two seeds, and on the first the two planted
    # faults the multi-step tolerance must see
    upd["ppo"] = card_vs_cpu("ppo", CFG["ppo"], 40, faults={
        "dropped minibatch": dropped_minibatch,
        "swapped epochs": swapped_epochs})
    upd["ppo_seed41"] = card_vs_cpu("ppo", CFG["ppo"], 41)
    # PPO's gradients: one Adam step on the whole default rollout
    upd["ppo_one_step"] = card_vs_cpu(
        "ppo", dataclasses.replace(CFG["ppo"], n_epochs=1, n_minibatches=1),
        43)
    for k, v in upd.items():
        print(f"training (a) update {k}, card vs CPU at 84x84x9: "
              f"{v['adam_steps']} Adam steps, losses within "
              f"{v['loss_rel_err']:.3g} of the CPU's (tol {v['loss_rtol']:g})"
              + "".join(f", planted {n} {e:.3g}"
                        for n, e in v["planted_faults"].items())
              + ", gradients "
              + ("not compared" if v["grad_rel_err"] is None
                 else f"{v['grad_rel_err']:.3g} of a leaf's largest")
              + f", params {v['param_abs_err']:.3g} "
              f"(tol {v['param_tol']:.3g})")

    envs = {}
    for task in ("pendulum", "hopper", "walker"):
        env = ENVS[task]
        s_cpu = env.reset(gen(50), 8)
        s_gpu = type(s_cpu)(*(x.to(dev) for x in s_cpu))
        rng = np.random.default_rng(51)
        st_err = rw_err = 0.0
        for _ in range(50):
            act = torch.from_numpy(rng.uniform(-1.2, 1.2, (8, env.action_dim))
                                   .astype(np.float32))
            s_cpu, r_c, d_c = env.step(s_cpu, act)
            s_gpu, r_g, d_g = env.step(s_gpu, act.to(dev))
            for w, g in zip(s_cpu, s_gpu):
                e = (g.cpu().double() - w.double()).abs()
                st_err = max(st_err, float((e / (1 + w.double().abs()))
                                           .max()))
            rw_err = max(rw_err, float((r_g.cpu() - r_c).abs().max()))
            check(torch.equal(d_g.cpu(), d_c), f"{task}: dones differ")
        check(st_err <= 1e-5 and rw_err <= 1e-5, f"{task}: card vs CPU "
              f"states {st_err:.3g}, rewards {rw_err:.3g} (tol 1e-5)")
        f_cpu = env.render(s_cpu)
        f_gpu = env.render(type(s_cpu)(*(x.to(dev) for x in s_cpu)))
        boundary = int(((f_gpu.cpu() - f_cpu).abs().amax(-1) > 0)
                       .reshape(8, -1).sum(-1).max())
        check(boundary <= 0.005 * 100 * 100, f"{task}: {boundary} pixels "
              f"of a frame differ (tol 0.5%)")
        oy = torch.randint(0, 17, (8,), device=dev)
        ox = torch.randint(0, 17, (8,), device=dev)
        check(torch.equal(crop(f_gpu, oy, ox),
                          env.render(type(s_cpu)(*(x.to(dev) for x in s_cpu)),
                                     (oy, ox, 84))),
              f"{task}: the window render is not the crop")
        envs[task] = dict(state_err=st_err, reward_err=rw_err,
                          boundary_pixels=boundary)
        print(f"training (a) env {task}, 8 envs x 50 steps card vs CPU: "
              f"states {st_err:.3g} (relative to 1 + |x|), rewards "
              f"{rw_err:.3g}, dones equal; {boundary} boundary pixels of a "
              f"frame differ; window render = crop")
    out["card_vs_cpu"] = {"updates": upd, "envs": envs,
                          "seconds": time.perf_counter() - t0}

    # ---- (b) train each pairing on the card ----------------------------
    runs, trained = {}, {}
    for task, algo in (("pendulum", "ddpg"), ("hopper", "sac"),
                       ("walker", "ppo")):
        cfg = CFG[algo]
        if algo == "ppo":
            budget = 2 * cfg.n_steps * cfg.n_envs
            n_upd = cfg.n_epochs * cfg.n_minibatches
        else:
            budget = cfg.learning_starts + 2 * TRAIN_CHUNK * cfg.n_envs
            n_upd = TRAIN_CHUNK * cfg.train_freq * cfg.n_envs
        t0 = time.perf_counter()
        with train_chunks(TRAIN_CHUNK):
            res = rl_train(task, "miniconv4", total_steps=budget, seed=7,
                           device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        leaves = tree_leaves(res.params)
        check(all(x.device.type == "cuda" and torch.isfinite(x).all()
                  and not x.requires_grad for x in leaves),
              f"{task}: trained params not finite plain tensors on the card")
        init = make_agent(algo, _pipeline_encoder("miniconv4", 9,
                                                  device=dev),
                          A[task], device=dev).init(gen(7))
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(leaves, tree_leaves(init.params)))
        check(moved > 0, f"{task}: no parameter moved")
        losses = [{k: float(v) for k, v in m.items()}
                  for _, _, m in res.phases if m]
        check(losses and all(np.isfinite(v) for m in losses
                             for v in m.values()),
              f"{task}: a loss is not finite: {losses}")
        n_steady = sum(p in [q for q, _, _ in res.phases[:i]]
                       for i, (p, _, _) in enumerate(res.phases))
        s = res.summary()
        row = dict(algo=algo, budget=budget,
                   plan=[list(p) for p, _, _ in res.phases],
                   phase_s=[dt for _, dt, _ in res.phases], wall_s=wall,
                   steady_env_steps_per_s=res.steady_steps_per_sec,
                   updates_per_s=n_upd * n_steady / res.steady_wall_s,
                   episodes_completed=s["episodes_completed"],
                   episodes_truncated=s["episodes_truncated"],
                   last_losses=losses[-1], params_moved=moved,
                   params=len(leaves))
        carry = res.carry
        if algo != "ppo":
            # the sync gate: one more steady chunk, the same function the
            # engine runs, under the debug mode; its end-of-chunk copy of
            # rewards and dones is outside the window
            agent = make_agent(algo, _pipeline_encoder("miniconv4", 9,
                                                       device=dev),
                               A[task], device=dev)
            chunk = offpolicy_chunk_fn(make_pixel_env(task), agent)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SyncCounter() as sc:
                carry = chunk(carry, n_steps=TRAIN_CHUNK, warmup=False)[0]
            torch.cuda.synchronize()
            row["steady_chunk_syncs"] = len(sc.syncs)
            row["gated_chunk_env_steps_per_s"] = TRAIN_CHUNK * cfg.n_envs / (
                time.perf_counter() - t0)
            check(not sc.syncs, f"{task}: the steady chunk synchronised "
                  f"with the host {len(sc.syncs)} times: {sc.syncs[:5]}")
        runs[task] = row
        trained[task] = (res, carry)
        print(f"training (b) {task}+{algo}: plan {row['plan']}, phases "
              + ", ".join(f"{x:.2f}" for x in row["phase_s"])
              + f" s; steady {row['steady_env_steps_per_s']:.1f} env-steps/s"
              f", {row['updates_per_s']:.1f} updates/s; episodes "
              f"{row['episodes_completed']} completed, "
              f"{row['episodes_truncated']} truncated; losses "
              f"{row['last_losses']}; {moved}/{len(leaves)} params moved"
              + (f"; one more steady chunk under the sync debug mode: "
                 f"{row['steady_chunk_syncs']} host syncs, "
                 f"{row['gated_chunk_env_steps_per_s']:.1f} env-steps/s"
                 if "steady_chunk_syncs" in row else ""))

    # ms a gradient update alone, and the PPO rollout's sync gate
    for task, algo in (("pendulum", "ddpg"), ("hopper", "sac"),
                       ("walker", "ppo")):
        res, carry = trained[task]
        env = make_pixel_env(task)
        agent = make_agent(algo, _pipeline_encoder("miniconv4", 9,
                                                   device=dev),
                           A[task], device=dev)
        if algo == "ppo":
            with SyncCounter() as sc:
                env_states, obs, traj = onpolicy_rollout(
                    env, agent, carry, agent.cfg.n_steps)
            runs[task]["rollout_syncs"] = len(sc.syncs)
            check(not sc.syncs, f"the PPO rollout synchronised with the "
                  f"host {len(sc.syncs)} times: {sc.syncs[:5]}")
            data = {"traj": traj, "last_obs": obs}
            n = agent.cfg.n_epochs * agent.cfg.n_minibatches

            def one():
                agent.update(carry.state, data, carry.gen)
        else:
            from repro_torch.rl.buffers import buffer_sample
            batch = buffer_sample(carry.buf, agent.cfg.batch_size, carry.gen)
            n = 1

            def one():
                st, _ = agent.update(carry.state, batch, carry.gen)
                agent.target_update(st)
        runs[task]["ms_per_update"] = host_ms(one) / n
        print(f"training (b) {task}+{algo}: "
              f"{runs[task]['ms_per_update']:.3f} ms a gradient update "
              f"(host clock around synchronize)"
              + (f"; the PPO rollout of {agent.cfg.n_steps} steps: "
                 f"{runs[task]['rollout_syncs']} host syncs"
                 if algo == "ppo" else ""))

    # one traced steady chunk (DDPG, 16 vector steps) and PPO rollout
    traces = {}
    for task, algo in (("pendulum", "ddpg"), ("walker", "ppo")):
        res, carry = trained[task]
        env = make_pixel_env(task)
        agent = make_agent(algo, _pipeline_encoder("miniconv4", 9,
                                                   device=dev),
                           A[task], device=dev)
        box = [carry]
        if algo == "ppo":
            def fn():
                onpolicy_rollout(env, agent, box[0], 16)
        else:
            chunk = offpolicy_chunk_fn(env, agent)

            def fn():
                box[0] = chunk(box[0], n_steps=16, warmup=False)[0]
        t = trace_decision(fn)
        if t["kernels"]:
            traces[task] = dict(
                steps=16, kernels=t["kernels"],
                kernels_per_step=t["kernels"] / 16, busy_ms=t["busy_ms"],
                traced_wall_ms=t["traced_wall_ms"],
                busy_share=t["busy_ms"] / t["traced_wall_ms"],
                top=[list(x) for x in t["top"]])
            print(f"training (b) trace, {task}+{algo} "
                  + ("rollout" if algo == "ppo" else "steady chunk")
                  + f" of 16 vector steps: {t['kernels']} kernels "
                  f"({t['kernels'] / 16:.1f} a step), device busy "
                  f"{t['busy_ms']:.3f} ms of {t['traced_wall_ms']:.3f} ms "
                  f"traced wall ({100 * t['busy_ms'] / t['traced_wall_ms']:.2f}"
                  f"%); top: " + "; ".join(f"{k[:50]} x{c} {ms:.3f} ms"
                                           for k, c, ms in t["top"]))
        else:
            traces[task] = None
            print(f"training (b) trace, {task}: the profiler saw no device "
                  f"time; busy share not measured")
    out["runs"] = runs
    out["traces"] = traces

    # ---- (c) serve the trained policies through K1 ---------------------
    serve = {}
    k1_launches = 0
    for task, algo in (("pendulum", "ddpg"), ("hopper", "sac")):
        res, _ = trained[task]
        cfg_f = DeploymentConfig.from_encoder_name("miniconv4", c_in=9,
                                                   backend="fused")
        dep_f = Deployment.build(cfg_f)
        dep_x = Deployment.build(dataclasses.replace(cfg_f, backend="xla"))
        dep_h = Deployment.build(dataclasses.replace(cfg_f,
                                                     backend="fused+head"))
        agent = make_agent(algo, dep_f.encoder, A[task], device=dev)
        head = agent.policy_head(res.params)
        _, obs = make_pixel_env(task, train=False).reset_batch(
            torch.Generator(device=dev).manual_seed(60), 8)
        client, server = dep_f.serving_pair(res.params, head=head)
        client_x, server_x = dep_x.serving_pair(res.params, head=head)
        reset_counts()
        payloads = [client.encode_fn(obs[i:i + 1]) for i in range(8)]
        actions = torch.stack(server.serve(payloads))
        with torch.inference_mode():
            z_h = dep_h.encoder.apply(res.params["encoder"], obs)
        torch.cuda.synchronize()
        launches = miniconv_encoder.launches
        k1_launches += launches
        check(launches == 9, f"{task}: the served trained policy launched "
              f"K1 {launches} times; expected 9 (8 requests + one batch)")
        payloads_x = [client_x.encode_fn(obs[i:i + 1]) for i in range(8)]
        actions_x = torch.stack(server_x.serve(payloads_x))
        with torch.inference_mode():
            z_x = dep_x.encoder.apply(res.params["encoder"], obs)
            float_actions = head(z_x)
        act_err = (actions - actions_x).abs().max().item()
        code_diff = max((p["data"].int() - q["data"].int()).abs().max()
                        .item() for p, q in zip(payloads, payloads_x))
        z_err = (z_h - z_x).abs().max().item()
        q_err = (actions - float_actions).abs().max().item()
        check(actions.shape == (8, A[task]) and act_err <= ACT_TOL
              and code_diff <= 1, f"{task}: served trained actions vs xla "
              f"{act_err} (tol {ACT_TOL}), codes within {code_diff}")
        check(torch.allclose(z_h, z_x, atol=Z_TOL, rtol=Z_TOL),
              f"{task}: fused+head z vs xla {z_err} (tol {Z_TOL})")
        serve[task] = dict(algo=algo, k1_launches=launches,
                           action_err=act_err, code_diff=code_diff,
                           z_err=z_err, vs_float_policy=q_err)
        print(f"training (c) {task}+{algo} trained policy served on fused: "
              f"K1 launches {launches} (8 requests at (1,84,84,9), one "
              f"(8,84,84,9) batch with the head); actions vs the xla build "
              f"{act_err:.3g} (tol {ACT_TOL}), codes within {code_diff}, z "
              f"{z_err:.3g} (tol {Z_TOL}), vs float policy {q_err:.3g}")
    out["serve"] = serve
    out["seconds"] = time.perf_counter() - t_phase
    print(f"training: {out['seconds']:.2f} s")
    return out, k1_launches


# Phase 15: populations.  The deterministic child's seeds, the eval seed
# and the tolerances of its gates.
POP_SEEDS = (70, 71)
POP_EVAL_SEED = 72
# vmap lanes against exact lanes after one update on the same batch (the
# tests' CPU figures: losses 1.6e-6, gradients 6.1e-6 of a leaf's largest)
POP_LOSS_RTOL = 1e-4
POP_GRAD_RTOL = 1e-4
# the vmap evaluator's 100 episodes against the exact one's, relative to
# the returns' scale (its policy is batched: its convs sum in another
# order)
POP_EVAL_RTOL = 1e-4
POP_PROBE_STEPS = 8        # the sync-gated chunk after training (16
                           # until the whole script neared 600 s)
POP_TRACE_STEPS = 1        # the traced chunk at P=16 (the profiler's own
                           # cost grows with the 12,000 kernels a step of
                           # the exact lanes; 2 until phase 21 came)
# Depth past the ring's warmup, in vector steps: (b)'s updates regime and
# (c)'s engines (8 until phase 18 came), and (d)'s member 0 (16 until
# then).  (c) traces a chunk after one untraced chunk of its own, so its
# engines need no longer run.
POP_UPDATE_STEPS = 4
POP_NONDET_STEPS = 8
# Vector steps past the ring's warmup of the deterministic child's
# population and of the train() run its member 0 is held against, in
# train chunks of POP_GATE_CHUNK (the child sets rollout.CHUNK): two
# chunks of one shape, so the engine carries its state across a boundary
# between train chunks, as at CHUNK, and the second chunk's rate is steady
# (two chunks of 128, 256 steps, until phase 21 came)
POP_GATE_STEPS = 64
POP_GATE_CHUNK = 32


def host_ms(fn, reps=5):
    """Host ms a call of ``fn``, ``reps`` calls after one, around a
    synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def population_gates(dev="cuda") -> int:
    """Phase 15's gates, run in a child process started with cuBLAS's
    deterministic workspace and ``torch.use_deterministic_algorithms``
    (``python3 chip_smoke.py --population-gates``).  It trains the
    4-member population once in each lane mode at phase 14's depth and
    prints one ``{"population_gates": ...}`` line."""
    import numpy as np
    import torch
    torch.use_deterministic_algorithms(True)
    # determinism does not need new memory filled: that only costs a fill
    # kernel an allocation
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.deploy import Deployment, DeploymentConfig
    from repro_torch.envs import make_pixel_env
    from repro_torch.kernels.miniconv_pass import miniconv_encoder
    from repro_torch.nn.module import tree_leaves
    from repro_torch.rl import population as pop
    from repro_torch.rl import rollout
    from repro_torch.rl.agent import make_agent
    from repro_torch.rl.buffers import population_sample
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.train import _pipeline_encoder
    from repro_torch.rl.train import train as rl_train

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    card = card_name()
    dev = torch.device(dev)
    cfg = DDPGConfig()
    rollout.CHUNK = POP_GATE_CHUNK
    budget = cfg.learning_starts + POP_GATE_STEPS * cfg.n_envs
    spec = pop.PopulationSpec(tasks=("pendulum",), seeds=POP_SEEDS,
                              variants=((), (("lr", 0.0),)),
                              total_steps=budget)
    out = {"card": card, "deterministic":
           torch.are_deterministic_algorithms_enabled(),
           "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
           "budget": budget, "members": spec.n_members}

    def equal(a, b):
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y)
                                          for x, y in zip(la, lb))

    def max_diff(a, b):
        return max(float((x - y).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    # ---- (a) population env rows against per-member calls --------------
    env = make_pixel_env("pendulum")
    seeds = (0, 1, 2, 3)
    states, obs = env.reset_population(
        [torch.Generator(device=dev).manual_seed(s) for s in seeds], 2)
    refs = [env.reset_batch(torch.Generator(device=dev).manual_seed(s), 2)
            for s in seeds]
    rows_equal = all(torch.equal(r[1], obs[p]) for p, r in enumerate(refs))
    act_gen = torch.Generator(device=dev).manual_seed(5)
    for _ in range(20):
        acts = torch.rand((4, 2, 1), generator=act_gen, device=dev) * 2 - 1
        states, obs, rew, done = env.step_population(states, acts)
        for p in range(4):
            s, o, r, d = env.step_batch(refs[p][0], acts[p])
            refs[p] = (s, o)
            rows_equal &= (torch.equal(o, obs[p]) and torch.equal(r, rew[p])
                           and torch.equal(d, done[p]))
    check(rows_equal, "step_population rows differ from per-member "
          "step_batch on the card")
    out["env_rows_bitwise"] = rows_equal

    # ---- (b) the population in each lane mode, and train() ------------
    runs = {}
    for mode in pop.LANE_MODES:
        t0 = time.perf_counter()
        with pop.vmap_fallbacks() as fb:
            res = pop.train_population(spec, lane_mode=mode,
                                       eval_episodes=100,
                                       eval_seed=POP_EVAL_SEED, device=dev)
            torch.cuda.synchronize()
        runs[mode] = res
        (run,) = res.runs
        losses = [float(v) for _, _, m in run.phases for x in m.values()
                  for v in x]
        check(losses and all(np.isfinite(losses)), f"{mode}: a loss is not "
              f"finite")
        check(all(torch.isfinite(x).all() for m in res.members
                  for x in tree_leaves(m.params)),
              f"{mode}: trained params not finite")
        check(not fb, f"{mode}: {len(fb)} ops fell back to vmap's "
              f"per-member loop: {fb[:3]}")
        check([p for p, _, _ in run.phases][-2:]
              == [("train", POP_GATE_CHUNK)] * 2,
              f"{mode}: the plan {[p for p, _, _ in run.phases]} does not "
              f"end in two train chunks of {POP_GATE_CHUNK}")
        steady = [(p, dt) for i, (p, dt, _) in enumerate(run.phases)
                  if p in [q for q, _, _ in run.phases[:i]]]
        out[mode] = dict(
            wall_s=time.perf_counter() - t0,
            program=res.program_stats[0],
            plan=[list(p) for p, _, _ in run.phases],
            phase_s=[dt for _, dt, _ in run.phases],
            steady_env_steps_per_s=(
                sum(p[1] * cfg.n_envs * len(res.members) for p, _ in steady)
                / sum(dt for _, dt in steady)),
            vmap_fallbacks=len(fb),
            eval_final_100_mean=[m.final_100_mean for m in res.members],
            last_losses={k: [float(x) for x in v]
                         for k, v in run.phases[-1][2].items()})
    t0 = time.perf_counter()
    single = rl_train("pendulum", "miniconv4", total_steps=budget,
                      seed=POP_SEEDS[0], device=dev)
    out["single_wall_s"] = time.perf_counter() - t0
    m0 = runs["exact"].members[0]
    want = single.carry.state
    member0 = dict(
        params=equal(m0.params, want.params),
        target=equal(m0.state.target, want.target),
        opt_state=(torch.equal(m0.state.opt_state.step, want.opt_state.step)
                   and equal(m0.state.opt_state.mu, want.opt_state.mu)
                   and equal(m0.state.opt_state.nu, want.opt_state.nu)),
        returns=(m0.episode_returns == single.episode_returns
                 and m0.truncated_returns == single.truncated_returns))
    check(all(member0.values()), f"exact member 0 is not train() at seed "
          f"{POP_SEEDS[0]} bitwise: {member0}")
    out["member0_bitwise"] = member0
    agent = make_agent("ddpg", _pipeline_encoder("miniconv4", 9, device=dev),
                       1, device=dev)
    frozen = {}
    for mode, res in runs.items():
        for m in res.members:
            if m.overrides == {"lr": 0.0}:
                init = agent.init(torch.Generator().manual_seed(m.seed))
                frozen[f"{mode} member {m.index}"] = equal(m.params,
                                                           init.params)
    check(all(frozen.values()), f"an lr=0 lane moved: {frozen}")
    out["lr0_frozen"] = frozen
    out["final_drift"] = [max_diff(e.params, v.params) for e, v in
                          zip(runs["exact"].members, runs["vmap"].members)]

    # ---- (c) the eval protocol -----------------------------------------
    t0 = time.perf_counter()
    eval_env = make_pixel_env("pendulum", train=False)
    stacked = pop.stack_trees([m.params for m in runs["exact"].members])
    exact_eval = pop.make_population_evaluator(eval_env, agent, 100,
                                               lane_mode="exact")
    again = exact_eval(stacked, POP_EVAL_SEED).cpu().numpy()
    first = np.stack([m.eval_returns for m in runs["exact"].members])
    check(np.array_equal(again, first), "the exact evaluator does not "
          "replay bitwise")
    batched = pop.make_population_evaluator(eval_env, agent, 100,
                                            lane_mode="vmap")
    with pop.vmap_fallbacks() as fb:
        vrows = batched(stacked, POP_EVAL_SEED).cpu().numpy()
    eval_err = float(np.abs(vrows - first).max() / np.abs(first).max())
    check(eval_err <= POP_EVAL_RTOL and not fb, f"vmap evaluator rows "
          f"{eval_err:.3g} of the exact ones' scale (tol {POP_EVAL_RTOL}), "
          f"{len(fb)} fallbacks")
    best = runs["exact"].best_member()
    check(np.isfinite(best.final_100_mean), "best member's final_100_mean "
          "is not finite")
    out["eval"] = dict(episodes=100, steps=eval_env.env.max_steps,
                       replay_bitwise=True, vmap_rel_err=eval_err,
                       best_member=best.index,
                       best_final_100_mean=best.final_100_mean,
                       seconds=time.perf_counter() - t0)

    # ---- (d) vmap against exact lanes at the first update --------------
    # the vmap engine warms up (no update), then both lanes take one
    # update of every member from that state on the same batch
    hyper = spec.programs()[0].hyper_values()
    enc = _pipeline_encoder("miniconv4", 9, device=dev)
    engine = pop.make_population_engine(
        env, "ddpg", enc, 1, cfg, hyper, 4, cfg.learning_starts + 2,
        lane_mode="vmap", device=dev)
    carry = engine.init([m.seed for m in runs["vmap"].members])
    carry = engine.run(carry, engine.plan()[0])[0]
    batch = population_sample(carry.buf, cfg.batch_size, carry.gen)
    lanes = pop.BatchedLanes("ddpg", enc, 1, cfg, hyper, device=dev)
    with pop.vmap_fallbacks() as fb:
        vs, vm = lanes.update(carry.state, batch, None)
    upd = {"loss_rel": 0.0, "grad_rel": 0.0, "param_abs": 0.0}
    for p, lr in enumerate(hyper["lr"]):
        a = make_agent("ddpg", enc, 1, device=dev,
                       cfg=dataclasses.replace(cfg, lr=lr))
        es, em = a.update(pop.member_tree(carry.state, p),
                          pop.member_tree(batch, p))
        es = a.target_update(es)
        for k in em:
            upd["loss_rel"] = max(upd["loss_rel"], max(
                abs(float(vm[k][p]) - float(em[k])) - 1e-5, 0.0)
                / abs(float(em[k])))
        for w, g in zip(tree_leaves(es.opt_state.mu),
                        tree_leaves(pop.member_tree(vs.opt_state.mu, p))):
            upd["grad_rel"] = max(upd["grad_rel"], float(
                (g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
        d = max_diff(es.params, pop.member_tree(vs.params, p))
        upd["param_abs"] = max(upd["param_abs"], d / max(lr, 1e-30)
                               if lr else d)
        if lr == 0.0:
            check(equal(pop.member_tree(vs.params, p),
                        pop.member_tree(carry.state.params, p)),
                  "the lr=0 member moved in the first update")
    check(upd["loss_rel"] <= POP_LOSS_RTOL and upd["grad_rel"]
          <= POP_GRAD_RTOL and upd["param_abs"] <= 2 and not fb,
          f"vmap lanes vs exact at the first update: {upd} (tol losses "
          f"{POP_LOSS_RTOL}, gradients {POP_GRAD_RTOL}, params 2 lr), "
          f"{len(fb)} fallbacks")
    out["first_update"] = dict(upd, param_unit="lr", vmap_fallbacks=len(fb))

    # ---- (e) no host sync in one more chunk of each mode ---------------
    syncs = {}
    for mode, res in runs.items():
        (run,) = res.runs
        torch.cuda.synchronize()
        with SyncCounter() as sc, pop.vmap_fallbacks() as fb:
            run.engine.run(run.carry, ("train", POP_PROBE_STEPS))
        torch.cuda.synchronize()
        syncs[mode] = len(sc.syncs)
        check(not sc.syncs and not fb, f"{mode}: the chunk synchronised "
              f"with the host {len(sc.syncs)} times: {sc.syncs[:5]}; "
              f"{len(fb)} fallbacks")
    out["chunk_syncs"] = syncs

    # ---- (f) serve the winner through K1 -------------------------------
    cfg_f = DeploymentConfig.from_encoder_name("miniconv4", c_in=9,
                                               backend="fused")
    dep_f = Deployment.build(cfg_f, device=dev)
    dep_x = Deployment.build(dataclasses.replace(cfg_f, backend="xla"),
                             device=dev)
    dep_h = Deployment.build(dataclasses.replace(cfg_f, backend="fused+head"),
                             device=dev)
    head = agent.policy_head(runs["exact"].best_params())
    _, obs = eval_env.reset_batch(
        torch.Generator(device=dev).manual_seed(60), 8)
    client, server = dep_f.export_best(runs["exact"], head=head)
    client_x, server_x = dep_x.export_best(runs["exact"], head=head)
    miniconv_encoder.launches = 0
    payloads = [client.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions = torch.stack(server.serve(payloads))
    with torch.inference_mode():
        z_h = dep_h.encoder.apply(best.params["encoder"], obs)
    torch.cuda.synchronize()
    launches = miniconv_encoder.launches
    payloads_x = [client_x.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions_x = torch.stack(server_x.serve(payloads_x))
    with torch.inference_mode():
        z_x = dep_x.encoder.apply(best.params["encoder"], obs)
    act_err = (actions - actions_x).abs().max().item()
    code_diff = max((p["data"].int() - q["data"].int()).abs().max().item()
                    for p, q in zip(payloads, payloads_x))
    z_err = (z_h - z_x).abs().max().item()
    check(launches == 9, f"export_best served through K1 {launches} times; "
          f"expected 9 (8 requests + one batch)")
    check(actions.shape == (8, 1) and act_err <= ACT_TOL and code_diff == 0,
          f"export_best actions vs xla {act_err} (tol {ACT_TOL}), codes "
          f"within {code_diff}")
    check(z_err <= Z_TOL, f"fused+head z vs xla {z_err} (tol {Z_TOL})")
    out["serve"] = dict(k1_launches=launches, action_err=act_err,
                        code_diff=code_diff, z_err=z_err,
                        best_member=best.index)
    out["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"population_gates": out}, default=float))
    return 0


def population_phase(dev, card):
    """Phase 15: populations on the card.  (a) the deterministic child's
    gates (:func:`population_gates`), run beside (b), (d) and (e); (b)
    aggregate env-steps/s at P = 1, 4 and 16 in each lane mode against the
    sequential baseline, in the collection regime (the vmap lanes' 3x gate
    at P=16) and with updates; (c) a traced steady chunk at P=16 in each
    mode and the ms of a stacked update, once the child has ended; (d)
    exact member 0 against ``train()`` without deterministic mode, at a
    cut depth; (e) ``benchmarks.learning --smoke``.  Returns the
    ``{"population": ...}`` dict."""
    import tempfile
    from repro_torch.rl import population as pop

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    say = lambda msg: print(f"population [{card}]: {msg}")  # noqa: E731
    out = {"card": card}

    # ---- (a) the gates, in a deterministic child beside (b), (d), (e) --
    # Its gates are bitwise or fixed-tolerance results of a deterministic
    # run, which the parent's work beside it cannot move; (b)'s rates and
    # (e)'s are measured beside it (the vmap lanes collected at 10.85x the
    # sequential rate at P=16 without it, on an NVIDIA H100 80GB HBM3 at
    # 700 W, against the 3x gate), (c)'s trace after it.
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--population-gates"], env=env, cwd=ROOT,
                             stdout=logs[0], stderr=logs[1], text=True)
    try:
        _population_parent(out, dev, say)
        t1 = time.perf_counter()
        child.wait(timeout=900)
        t_end = time.perf_counter()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    stdout, stderr = (f.seek(0) or f.read() for f in logs)
    check(child.returncode == 0, f"the deterministic child failed "
          f"({child.returncode}): {stderr[-3000:]}")
    gates = json.loads(stdout.strip().splitlines()[-1])["population_gates"]
    # the child had ended by t_end: its process time is at most that
    gates["process_s"], gates["waited_s"] = t_end - t0, t_end - t1
    out["gates"] = gates
    _population_trace(out, dev, say)
    for mode in pop.LANE_MODES:
        g = gates[mode]
        say(f"(a) {mode} lanes, 4 members x {gates['budget']} steps in "
            f"deterministic mode: {g['wall_s']:.2f} s (eval included), "
            f"plan {g['plan']}, phases "
            + ", ".join(f"{x:.2f}" for x in g["phase_s"])
            + f" s, steady {g['steady_env_steps_per_s']:.1f} aggregate "
            f"env-steps/s, {g['vmap_fallbacks']} vmap fallbacks, "
            f"final_100_mean {g['eval_final_100_mean']}")
    say(f"(a) exact member 0 vs train() bitwise: {gates['member0_bitwise']};"
        f" lr=0 lanes frozen: {gates['lr0_frozen']}; step_population rows "
        f"bitwise: {gates['env_rows_bitwise']}; first update vmap vs exact:"
        f" {gates['first_update']}; drift at the end "
        f"{gates['final_drift']}; host syncs in one more chunk "
        f"{gates['chunk_syncs']}; eval {gates['eval']}; export_best "
        f"through K1 {gates['serve']}; child {gates['process_s']:.2f} s "
        f"at most, {gates['waited_s']:.2f} s of it after (e))")
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase {out['seconds']:.2f} s")
    return out


def _population_parent(out, dev, say):
    """Phase 15's (b), (d) and (e), run beside the deterministic child;
    fills ``out``."""
    import torch
    from repro_torch.benchmarks import learning as bench_learning
    from repro_torch.benchmarks import population as bench_pop
    from repro_torch.nn.module import tree_leaves
    from repro_torch.rl import population as pop
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.train import train as rl_train

    # ---- (b) aggregate throughput against the sequential baseline ------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grids = {}
    coll = bench_pop.run_grid((1, 4, 16), total_steps=64, n_envs=2,
                              device=dev)
    upd_cfg = DDPGConfig(learning_starts=DDPGConfig().batch_size)
    upd_steps = upd_cfg.learning_starts + POP_UPDATE_STEPS * upd_cfg.n_envs
    upd = bench_pop.run_grid((1, 4, 16), total_steps=upd_steps,
                             n_envs=upd_cfg.n_envs, cfg=upd_cfg,
                             regime="updates", device=dev)
    for name, rows in (("collection", coll), ("updates", upd)):
        grids[name] = rows
        for r in rows:
            say(f"(b) {name}: {r['lane_mode']} P={r['P']}: warm "
                f"{r['steady_aggregate_steps_per_sec']:.1f} aggregate "
                f"env-steps/s vs sequential "
                f"{r['steady_sequential_steps_per_sec']:.1f}: "
                f"{r['speedup_vs_sequential']:.2f}x; first passes "
                f"{r['aggregate_steps_per_sec']:.1f} vs "
                f"{r['sequential_steps_per_sec']:.1f}: "
                f"{r['first_pass_speedup_vs_sequential']:.2f}x")
    top = next(r for r in coll if r["lane_mode"] == "vmap" and r["P"] == 16)
    check(top["speedup_vs_sequential"] >= bench_pop.SMOKE_SPEEDUP,
          f"vmap lanes at P=16 collect {top['speedup_vs_sequential']:.2f}x "
          f"the sequential baseline, warm (< {bench_pop.SMOKE_SPEEDUP:g}x)")
    check(all(r["speedup_vs_sequential"] >= 1.0 for r in coll
              if r["lane_mode"] == "vmap" and r["P"] > 1),
          "vmap lanes slower than sequential in collection")
    out["grids"] = grids
    out["grids_s"] = time.perf_counter() - t0

    # ---- (d) member 0 without deterministic mode, at a cut depth --------
    t0 = time.perf_counter()
    cfg = DDPGConfig()
    cut = cfg.learning_starts + POP_NONDET_STEPS * cfg.n_envs
    spec = pop.PopulationSpec(tasks=("pendulum",), seeds=POP_SEEDS,
                              variants=((), (("lr", 0.0),)), total_steps=cut)
    res = pop.train_population(spec, eval_episodes=0, device=dev)
    single = rl_train("pendulum", "miniconv4", total_steps=cut,
                      seed=POP_SEEDS[0], device=dev)
    nondet = max(float((a - b).abs().max()) for a, b in
                 zip(tree_leaves(res.members[0].params),
                     tree_leaves(single.params)))
    out["member0_nondeterministic"] = dict(
        budget=cut, max_abs_diff=nondet,
        seconds=time.perf_counter() - t0)
    say(f"(d) exact member 0 vs train() WITHOUT deterministic mode, "
        f"{cut} steps: params differ by at most {nondet:.3g}")

    # ---- (e) the learning benchmark's smoke gate -----------------------
    t0 = time.perf_counter()
    doc = bench_learning.main(["--smoke", "--device", str(dev), "--json",
                               str(ROOT / "build" / "learning.json")])
    out["learning"] = dict(
        conditions=[{k: c[k] for k in ("task", "algo", "best", "mean",
                                       "final", "episodes_completed",
                                       "steps_per_sec",
                                       "steady_steps_per_sec")}
                    for c in doc["conditions"]],
        seconds=time.perf_counter() - t0)
    say(f"learning --smoke {out['learning']['seconds']:.2f} s")


def _population_trace(out, dev, say):
    """Phase 15's (c), run once the deterministic child has ended: a
    profiler trace shared with another process's kernels reads their
    time too.  Fills ``out``."""
    import torch
    from repro_torch.benchmarks.lm_split import trace_decision
    from repro_torch.envs import make_pixel_env
    from repro_torch.rl import population as pop
    from repro_torch.rl.agent import make_agent
    from repro_torch.rl.buffers import population_sample
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.train import _pipeline_encoder

    # ---- (c) a traced steady chunk at P=16, and a stacked update -------
    upd_cfg = DDPGConfig(learning_starts=DDPGConfig().batch_size)
    upd_steps = upd_cfg.learning_starts + POP_UPDATE_STEPS * upd_cfg.n_envs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = make_pixel_env("pendulum")
    enc = _pipeline_encoder("miniconv4", 9, device=dev)
    traces, updates = {}, {}
    for mode in pop.LANE_MODES:
        engine = pop.make_population_engine(
            pend, "ddpg", enc, 1, upd_cfg, {}, 16, upd_steps,
            lane_mode=mode, device=dev)
        carry = engine.init(list(range(16)))
        for phase in engine.plan():
            carry = engine.run(carry, phase)[0]
        box = [carry]

        def chunk():
            box[0] = engine.run(box[0], ("train", POP_TRACE_STEPS))[0]
        t = trace_decision(chunk)
        n = POP_TRACE_STEPS
        traces[mode] = None if not t["kernels"] else dict(
            members=16, steps=n, kernels=t["kernels"],
            kernels_per_step=t["kernels"] / n, busy_ms=t["busy_ms"],
            traced_wall_ms=t["traced_wall_ms"],
            busy_share=t["busy_ms"] / t["traced_wall_ms"],
            top=[list(x) for x in t["top"]])
        say(f"(c) trace, {mode} lanes, 16 members, a steady chunk of {n} "
            f"vector steps: " + ("the profiler saw no device time" if not
                                 t["kernels"] else
                                 f"{t['kernels']} kernels "
                                 f"({t['kernels'] / n:.1f} a vector step), "
                                 f"device busy {t['busy_ms']:.3f} ms of "
                                 f"{t['traced_wall_ms']:.3f} ms "
                                 f"({100 * t['busy_ms'] / t['traced_wall_ms']:.2f}"
                                 f"%); top: " + "; ".join(
                                     f"{k[:50]} x{c} {ms:.3f} ms"
                                     for k, c, ms in t["top"])))
        if mode == "vmap":
            state = engine.state(box[0])
            lanes = pop.BatchedLanes("ddpg", enc, 1, upd_cfg, {}, device=dev)
            batch = population_sample(box[0].buf, upd_cfg.batch_size,
                                      box[0].gen)
            for P in (4, 16):
                st = pop.member_tree(state, slice(0, P))
                b = pop.member_tree(batch, slice(0, P))
                updates[f"vmap_P{P}_ms"] = host_ms(
                    lambda: lanes.update(st, b, None))
            agent = make_agent("ddpg", enc, 1, cfg=upd_cfg, device=dev)
            st1, b1 = pop.member_tree(state, 0), pop.member_tree(batch, 0)
            updates["single_ms"] = host_ms(
                lambda: agent.target_update(agent.update(st1, b1)[0]))
    say(f"(c) ms a stacked update (update and target step, batch "
        f"{upd_cfg.batch_size} a member, host clock around synchronize): "
        f"vmap P=4 "
        f"{updates['vmap_P4_ms']:.3f}, P=16 {updates['vmap_P16_ms']:.3f}; "
        f"one member alone {updates['single_ms']:.3f} (x16 = "
        f"{16 * updates['single_ms']:.3f})")
    out["traces"] = traces
    out["stacked_update"] = updates
    out["trace_s"] = time.perf_counter() - t0

# Phase 16: the LM decode path and training at full width.  Tolerances:
# full-width decode against the K5 forward in f32 over an f32 cache, the
# reference's own decode-against-forward setting and tolerance
# (tests/test_models.py:73-91); in bf16, the served precision, any two
# computations of the 28 layers part by more than that (the K5 forward
# and an eager one by about 0.07 in logits of std 0.64, each about 0.06
# from the f32 forward on the same weights; this phase prints them), so
# the bf16 decode must stay within LM_BF16_FLOOR times the K5 forward's
# own distance from the f32 forward; decode against forward on the card
# and the card against the CPU in f32 for 2 layers; one training step
# card against CPU (phase 14's conventions: gradients relative to each
# leaf's largest, parameters within 2 lr, the loss absolute).
LM_DECODE_TOL = 2e-2
LM_BF16_FLOOR = 1.5
LM_DECODE_F32_TOL = 1e-4
LM_GRAD_TOL = 1e-4
LM_LOSS_TOL = 1e-4


def lm_phase(dev, gen, reset_counts, counts):
    """Phase 16: the LM decode path and training at Qwen3-0.6B's full
    width.  (a) the full-width parameters drawn once (seed 0, as
    ``build_split``): a 128-token prompt decoded one token at a time into
    a 256-deep bf16 cache against ``forward`` (K5, 28 launches), then 32
    greedy tokens twice, bitwise; ms a token, a traced step, and one step
    at decode_32k's depth at B = 1 and 8; (b) phase 10's 2-layer
    full-width f32 config: decode against forward on the card, decode and
    one ``Trainer`` step card against CPU, no K5 launch in the step, and
    ``flash_attention`` refusing inputs that require grad; (c) ``python -m
    repro_torch.launch.train --full`` for 8 steps from (a)'s parameters,
    then a checkpoint saved and restored on the card, the loss bitwise
    equal.  Returns the ``{"lm": ...}`` dict."""
    import math
    import shutil
    import torch
    from repro_torch.benchmarks.lm_split import trace_decision
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn.module import (cast_tree, param_bytes, param_count,
                                       tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import TrainConfig, Trainer

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    lm = {}

    # ---- (a) decode at full width ------------------------------------------
    cfg, model = get_model("qwen3-0.6b", reduced=False)
    check(cfg.n_layers == 28 and cfg.d_model == 1024 and cfg.n_heads == 16
          and cfg.n_kv_heads == 8 and cfg.head_dim == 128
          and cfg.vocab == 151936 and cfg.dtype == "bfloat16",
          f"not full width: {cfg}")
    t0 = time.perf_counter()
    # drawn on the card, as build_split draws them (a host generator takes
    # 20 s or more for 596 M values)
    params = serve_cli.init_params(model, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, w_bytes = param_count(params), param_bytes(params)
    P, MAX, NEW = 128, 256, 32
    prompt = torch.randint(3, cfg.vocab, (1, P), generator=gen(13)) \
        .to(dev, torch.int32)
    # the oracles: the served bf16 model and its f32 copy (the reference's
    # own setting), each a forward through K5 (28 launches)
    model32 = DecoderModel(dataclasses.replace(cfg, dtype="float32"))
    params32 = cast_tree(params, torch.float32)
    oracles = {}
    for name, m, p in (("bf16", model, params), ("f32", model32, params32)):
        reset_counts()
        with torch.inference_mode():
            oracles[name] = m.forward(p, prompt)[0]
        torch.cuda.synchronize()
        oracle = counts()
        check(oracle == (0, 0, 0, 0, 28), f"the {name} oracle forward "
              f"launched K1..K5 {oracle}; expected (0, 0, 0, 0, 28)")

    def clone(c):
        return tree_map(lambda t: t.clone(), c)

    def decode_prompt(m, p, dtype):
        c = m.init_cache(1, MAX, dtype, device=dev)
        i = torch.zeros((), dtype=torch.int64, device=dev)
        out = []
        for t in range(P):
            lg, c = m.decode_step(p, prompt[:, t:t + 1], c, i)
            i += 1
            out.append(lg)
        return torch.cat(out, 1), c

    # the same bf16 forward on the eager attention branches (its
    # parameters require grad, so no core reaches K5): a second bf16
    # computation of the oracle, to show how far two of them part
    grad_leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    reset_counts()
    with torch.enable_grad():
        eager = model.forward(tree_unflatten(params, grad_leaves),
                              prompt)[0].detach()
    torch.cuda.synchronize()
    check(counts() == (0,) * 5, f"the eager forward launched K1..K5 "
          f"{counts()}")
    del grad_leaves

    reset_counts()
    dec32, _ = decode_prompt(model32, params32, torch.float32)
    dec, caches = decode_prompt(model, params, torch.bfloat16)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    check(all(t.dtype == torch.bfloat16 for t in tree_leaves(caches)),
          "the default cache is not bf16")
    after_prompt = clone(caches)

    def greedy(c):
        i = torch.full((), P, dtype=torch.int64, device=dev)
        tok = dec[:, -1:].argmax(-1).to(torch.int32)
        toks, lgs = [], []
        for _ in range(NEW):
            lg, c = model.decode_step(params, tok, c, i)
            i += 1
            toks.append(tok)
            lgs.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        return torch.cat(toks, 1), torch.cat(lgs, 1), c

    c1 = clone(after_prompt)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    toks1, lg1, c1 = greedy(c1)
    ev1.record()
    ev1.synchronize()
    tok_host_ms = (time.perf_counter() - t0) * 1e3 / NEW
    tok_ev_ms = ev0.elapsed_time(ev1) / NEW
    toks2, lg2, c2 = greedy(clone(after_prompt))
    torch.cuda.synchronize()
    decode_counts = counts()

    def max_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    full, full32 = oracles["bf16"], oracles["f32"]
    err32 = max_err(dec32, full32)
    err = max_err(dec, full)
    floor = max_err(full, full32)      # the K5 bf16 forward's own distance
    eager_floor = max_err(eager, full32)
    eager_vs_k5 = max_err(eager, full)
    err_truth = max_err(dec, full32)
    top1 = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    top1_32 = (dec32.argmax(-1) == full32.argmax(-1)).float().mean().item()
    repeat = (torch.equal(toks1, toks2) and torch.equal(lg1, lg2)
              and all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(c1), tree_leaves(c2))))
    print(f"LM decode qwen3-0.6b full width (28 layers, d 1024, 16/8 "
          f"heads, head_dim 128, vocab 151936, {n_params} parameters drawn "
          f"in {init_s:.2f} s), B=1, {P} prompt tokens one at a time "
          f"against the forward's logits (K5 28 launches each): f32 model "
          f"and cache max_abs_err {err32:.4g} (tol {LM_DECODE_TOL}), top-1 "
          f"{top1_32:.4f}; bf16 over the bf16 cache ({MAX} deep, "
          f"{cache_bytes} B) max_abs_err {err:.4g} against the bf16 "
          f"forward, top-1 {top1:.4f}, {err_truth:.4g} against the f32 "
          f"forward where the bf16 forward is {floor:.4g} from it (limit "
          f"{LM_BF16_FLOOR}x; the eager bf16 forward {eager_floor:.4g} from "
          f"it and {eager_vs_k5:.4g} from K5's); K1..K5 launches while "
          f"decoding "
          f"{decode_counts}; {NEW} greedy tokens {toks1[0].tolist()}, twice "
          f"bitwise equal {repeat}; {tok_ev_ms:.4f} ms a token by CUDA "
          f"events, {tok_host_ms:.4f} ms by the host clock")
    check(decode_counts == (0, 0, 0, 0, 0), f"decoding launched K1..K5 "
          f"{decode_counts}; expected none")
    check(torch.allclose(dec32, full32, atol=LM_DECODE_TOL,
                         rtol=LM_DECODE_TOL),
          f"full-width f32 decode differs from the K5 forward by {err32} "
          f"(tol {LM_DECODE_TOL})")
    check(err_truth <= LM_BF16_FLOOR * floor,
          f"full-width bf16 decode is {err_truth} from the f32 forward, "
          f"more than {LM_BF16_FLOOR} x the bf16 forward's {floor}")
    check(repeat, "the greedy continuation does not repeat bit for bit")
    del params32, model32, dec32, full32, oracles, eager

    c3 = clone(after_prompt)
    i3 = torch.full((), P, dtype=torch.int64, device=dev)
    tr = trace_decision(lambda: model.decode_step(params, toks1[:, :1], c3,
                                                  i3))
    busy = (None if not tr["kernels"]
            else tr["busy_ms"] / tr["traced_wall_ms"])
    print(f"profile of one decode step: {tr['kernels']} kernels, device "
          f"busy {tr['busy_ms']:.4f} ms of {tr['traced_wall_ms']:.4f} ms "
          f"traced wall ("
          + ("not measured" if busy is None else f"{100 * busy:.2f}%")
          + "); top: " + "; ".join(f"{k[:60]} x{n} {ms:.4f} ms"
                                   for k, n, ms in tr["top"]))
    del c1, c2, c3, caches, after_prompt, lg1, lg2, dec, full

    deep = {}
    for B in (1, 8):
        c = model.init_cache(B, 32768, device=dev)
        nb = sum(t.numel() * t.element_size() for t in tree_leaves(c))
        tokB = torch.full((B, 1), 5, dtype=torch.int32, device=dev)
        iB = torch.full((), 32767, dtype=torch.int64, device=dev)
        ms = cuda_ms(lambda: model.decode_step(params, tokB, c, iB),
                     iters=3, warmup=1)
        b_ms = (w_bytes + nb) / PEAK_BYTES_S * 1e3
        deep[B] = dict(ms=ms, cache_bytes=nb, bound_ms=b_ms,
                       peak_bytes=torch.cuda.max_memory_allocated())
        print(f"decode_32k depth, B={B}: cache {nb} B, one step "
              f"{ms:.4f} ms by CUDA events (mean of 3), bytes bound "
              f"{b_ms:.4f} ms (weights + cache once)")
        del c
        torch.cuda.empty_cache()
    lm["decode"] = dict(
        prompt=P, new_tokens=NEW, cache_len=MAX, cache_bytes=cache_bytes,
        params=n_params, weight_bytes=w_bytes, init_s=init_s,
        oracle_k5_launches=28, launches=list(decode_counts),
        f32_max_abs_err=err32, tol=LM_DECODE_TOL, f32_top1=top1_32,
        bf16_max_abs_err=err, bf16_top1=top1,
        bf16_vs_f32_err=err_truth, bf16_forward_vs_f32_err=floor,
        bf16_eager_forward_vs_f32_err=eager_floor,
        bf16_eager_vs_k5_forward_err=eager_vs_k5,
        bf16_floor_limit=LM_BF16_FLOOR,
        greedy_tokens=toks1[0].tolist(), greedy_bitwise=repeat,
        ms_per_token_events=tok_ev_ms, ms_per_token_host=tok_host_ms,
        bound_ms_per_token=(w_bytes + cache_bytes) / PEAK_BYTES_S * 1e3,
        traced_kernels=tr["kernels"], traced_busy_ms=tr["busy_ms"],
        traced_wall_ms=tr["traced_wall_ms"], busy_share=busy,
        top=tr["top"], depth_32k={str(b): v for b, v in deep.items()})

    # ---- (b) the card against the CPU, phase 10's 2-layer f32 config -------
    cfg_c = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                                n_pattern=2, dtype="float32")
    model_c = DecoderModel(cfg_c)
    p_cpu = model_c.init(gen(21), device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    S_b = 64
    tok = torch.randint(3, cfg_c.vocab, (1, S_b), generator=gen(22)) \
        .to(torch.int32)

    def decode_all(p, toks, device):
        c = model_c.init_cache(1, S_b, torch.float32, device=device)
        i = torch.zeros((), dtype=torch.int64, device=device)
        outs = []
        for t in range(S_b):
            lg, c = model_c.decode_step(p, toks[:, t:t + 1], c, i)
            i += 1
            outs.append(lg)
        return torch.cat(outs, 1)

    reset_counts()
    with torch.inference_mode():
        fwd_g, _ = model_c.forward(p_gpu, tok.to(dev))
    torch.cuda.synchronize()
    fwd_counts = counts()
    reset_counts()
    dec_g = decode_all(p_gpu, tok.to(dev), dev)
    torch.cuda.synchronize()
    dec_counts_b = counts()
    dec_c = decode_all(p_cpu, tok, "cpu")
    e_fwd = (dec_g - fwd_g).abs().max().item()
    e_cpu = (dec_g.cpu() - dec_c).abs().max().item()
    cpu_tol = LM_CPU_TOL["full width"]
    print(f"LM decode card vs CPU, full width f32 (2 layers), {S_b} tokens, "
          f"f32 cache: decode vs the card's forward (K5 launches "
          f"{fwd_counts[4]}) max_abs_err {e_fwd:.4g} (tol "
          f"{LM_DECODE_F32_TOL}); card vs CPU {e_cpu:.4g} (tol {cpu_tol}); "
          f"K1..K5 launches while decoding {dec_counts_b}")
    check(fwd_counts == (0, 0, 0, 0, 2) and dec_counts_b == (0,) * 5,
          f"(b): forward launched {fwd_counts}, decode {dec_counts_b}")
    check(torch.allclose(dec_g, fwd_g, atol=LM_DECODE_F32_TOL,
                         rtol=LM_DECODE_F32_TOL),
          f"f32 decode differs from the card's forward by {e_fwd}")
    check(torch.allclose(dec_g.cpu(), dec_c, atol=cpu_tol, rtol=cpu_tol),
          f"f32 decode: card differs from CPU by {e_cpu} (tol {cpu_tol})")
    del fwd_g, dec_g, dec_c

    lr = 1e-3
    tcfg = TrainConfig(batch=2, steps=10, lr=lr, warmup=1)
    batch = next(lm_batches(cfg_c.vocab, 2, S_b, seed=3, device="cpu"))
    names = [p for p, _ in tree_paths(p_cpu)]

    def one_step(p, device):
        b = {k: v.to(device) for k, v in batch.items()}
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = model_c.loss(tree_unflatten(p, leaves), b, remat=False)
        grads = torch.autograd.grad(loss, leaves)
        trainer = Trainer(cfg_c, tcfg, device=device)
        new, _, m = trainer.step(p, trainer.optimizer.init(p), b)
        return loss.detach(), grads, new, m

    reset_counts()
    loss_g, grads_g, new_g, m_g = one_step(p_gpu, dev)
    torch.cuda.synchronize()
    step_counts = counts()
    loss_c, grads_c, new_c, m_c = one_step(p_cpu, "cpu")
    g_err = max((a.cpu() - b).abs().max().item()
                / max(b.abs().max().item(), 1e-30)
                for a, b in zip(grads_g, grads_c))
    p_err = max((a.cpu() - b).abs().max().item()
                for a, b in zip(tree_leaves(new_g), tree_leaves(new_c)))
    l_err = abs(float(m_g["loss"]) - float(m_c["loss"]))
    named = dict(zip(names, grads_g))
    qkv_min = min(
        named[f"scan/b0_attn/attn/{n}/kernel"].abs().flatten(1).amax(1)
        .min().item() for n in ("wq", "wk", "wv"))
    try:
        q, k, v = (torch.randn((1, 16 if i == 0 else 8, 128, 128),
                               generator=gen(40 + i)).to(dev, torch.bfloat16)
                   for i in range(3))
        q.requires_grad_()
        before = flash_attention.launches
        flash_attention(q, k, v, causal=True)
        refused = False
    except RuntimeError:
        refused = flash_attention.launches == before
    print(f"LM train step card vs CPU, full width f32 (2 layers), batch "
          f"(2,{S_b}): loss {float(m_g['loss']):.6f}, error {l_err:.3g} "
          f"(tol {LM_LOSS_TOL}); gradients {g_err:.3g} of each leaf's "
          f"largest (tol {LM_GRAD_TOL}); parameters {p_err:.3g} (tol "
          f"{2 * lr}); K1..K5 launches in the card's step {step_counts}; "
          f"smallest per-layer max |grad| of wq/wk/wv {qkv_min:.3g}; "
          f"flash_attention refused CUDA inputs that require grad "
          f"{refused}")
    check(step_counts == (0,) * 5, f"a training step launched K1..K5 "
          f"{step_counts}; K5 has no backward pass")
    check(g_err <= LM_GRAD_TOL and p_err <= 2 * lr and l_err <= LM_LOSS_TOL,
          f"train step card vs CPU: gradients {g_err}, parameters {p_err}, "
          f"loss {l_err}")
    check(qkv_min > 0, "a q/k/v projection received a zero gradient")
    check(refused, "flash_attention ran on CUDA inputs that require grad")
    lm["card_vs_cpu"] = dict(
        decode_vs_forward_err=e_fwd, decode_vs_forward_tol=LM_DECODE_F32_TOL,
        decode_cpu_err=e_cpu, decode_cpu_tol=cpu_tol,
        step_loss_err=l_err, step_grad_err=g_err, step_param_err=p_err,
        step_launches=list(step_counts), qkv_grad_min=qkv_min,
        k5_refuses_grad=refused)
    del p_cpu, p_gpu, new_g, new_c, grads_g, grads_c

    # ---- (c) training at full width: the launcher, then a checkpoint -------
    torch.cuda.reset_peak_memory_stats()
    argv = ["--full", "--arch", "qwen3-0.6b", "--steps", "8", "--batch",
            "4", "--seq", "256", "--device", "cuda"]
    rep = {}
    reset_counts()
    t0 = time.perf_counter()
    rc = train_cli.main(argv, params=params, report=rep)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    hist = rep["history"]
    losses = [h["loss"] for h in hist]
    first, last = hist[0], hist[-1]
    step_ms = ((last["wall_s"] - first["wall_s"])
               / (last["step"] - first["step"]) * 1e3)
    B, S = 4, 256
    tokens_s = B * S / (step_ms / 1e3)
    attn_flops = 12 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    step_flops = 6 * n_params * B * S + attn_flops
    mfu = step_flops / (step_ms / 1e3) / PEAK_BF16_FLOP_S
    path = ROOT / "build" / "lm_ckpt"
    t0 = time.perf_counter()
    checkpoint.save(str(path), {"params": rep["params"]}, step=8)
    save_s = time.perf_counter() - t0
    back = checkpoint.restore(str(path), {"params": rep["params"]},
                              device=dev)["params"]
    leaves_equal = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(back), tree_leaves(rep["params"])))
    b = rep["trainer"].batch_to_device(next(rep["data"]))
    with torch.no_grad():
        l1, _ = model.loss(rep["params"], b, remat=False)
        l2, _ = model.loss(back, b, remat=False)
    shutil.rmtree(path, ignore_errors=True)
    print(f"LM training qwen3-0.6b full width, launch.train {' '.join(argv)} "
          f"from (a)'s parameters: exit {rc}; losses at steps "
          f"{[h['step'] for h in hist]}: {losses}; {step_ms:.4f} ms a step "
          f"after the first ({tokens_s:.1f} tokens/s), first step "
          f"{first['wall_s'] * 1e3:.4f} ms; {step_flops:.4g} FLOP a step, "
          f"MFU {100 * mfu:.3f}% of {PEAK_BF16_FLOP_S:.3g} FLOP/s; peak "
          f"device memory {peak} B; K1..K5 launches while training "
          f"{train_counts}; {train_s:.2f} s; checkpoint saved in "
          f"{save_s:.2f} s, restored on the card: leaves bitwise "
          f"{leaves_equal}, loss {float(l1):.6f} == {float(l2):.6f} "
          f"bitwise {torch.equal(l1, l2)}")
    check(rc == 0 and all(math.isfinite(x) for x in losses),
          f"launch.train --full exited {rc} with losses {losses}")
    check(train_counts[4] == 0, f"training launched K5 {train_counts[4]} "
          f"times")
    check(leaves_equal and torch.equal(l1, l2),
          f"checkpoint restore: leaves equal {leaves_equal}, losses "
          f"{float(l1)} and {float(l2)}")
    phase_s = time.perf_counter() - t_phase
    lm["train"] = dict(
        argv=argv, rc=rc, steps=[h["step"] for h in hist], losses=losses,
        ms_per_step=step_ms, first_step_ms=first["wall_s"] * 1e3,
        tokens_per_s=tokens_s, step_flops=step_flops, mfu=mfu,
        peak_bytes=peak, launches=list(train_counts), seconds=train_s,
        ckpt_save_s=save_s, ckpt_bitwise=True)
    lm["seconds"] = phase_s
    print(f"LM phase: {phase_s:.2f} s (target 60 s)")
    return lm


# Phase 17: the MoE, Mamba-2 (SSM) and RG-LRU (hybrid) decoder families at
# their published widths.  Gates: one split decision's K5 launches (one
# per attention block whose core K5 admits: recurrentgemma-9b's logit
# softcap keeps its cores eager, as in the reference); the float32-codec
# split bit for bit the monolith (the server half leaves the softcap out,
# as the reference's, so the softcap is applied to it first); init's peak
# memory within FAM_INIT_PEAK of the parameters' bytes; decode against
# the forward (the MoE's at a capacity that drops nothing: a decode step
# routes one token, the forward 128, and drops some at the default
# capacity) in f32 over an f32 cache, the reference's own setting, within
# LM_DECODE_TOL with top-1 agreement >= FAM_TOP1, and in bf16, the served
# precision, within LM_BF16_FLOOR times the bf16 forward's own distance
# from the f32 forward (phase 16's rule: any two bf16 computations of the
# 24-38 layers part by more than 2e-2, and their top-1 agreement falls
# below 0.95 on these near-flat random-weight logits; this phase prints
# it); the card against the CPU on each family's 2-layer f32 reduced()
# config, logits of the forward and of 16 decode steps within FAM_CPU_TOL
# of their largest, the MoE's expert indices equal and its moe_aux_loss
# within FAM_AUX_TOL; K5 at the MoE's shape against its plain version
# (ATTN_TOL); mamba2-130m training losses finite, one step's gradients
# card against CPU within FAM_GRAD_TOL of each leaf's largest.
FAM_TOP1 = 0.95
FAM_CPU_TOL = 1e-5
FAM_AUX_TOL = 1e-6
FAM_GRAD_TOL = 1e-5
FAM_INIT_PEAK = 1.25
# cheapest first: (arch, K5 launches a split decision)
FAMILIES = (("mamba2-130m", 0), ("recurrentgemma-9b", 0),
            ("qwen2-moe-a2.7b", 24))


def cast_in_place(tree, dtype):
    """``tree`` with every floating leaf cast to ``dtype``, one leaf at a
    time, each replaced in its dict as it is cast (the old leaf is freed
    once nothing else holds it)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            cast_in_place(v, dtype)
        elif v.is_floating_point():
            tree[k] = v.to(dtype)
    return tree


# The split decision and decode of one decoder at its published width,
# shared by phases 17 and 21: a 128-token prompt, a 256-deep cache and 32
# greedy tokens.
DEC_PROMPT, DEC_MAX, DEC_NEW = 128, 256, 32


def ample(cfg):
    """The config at a capacity that drops nothing (C = G)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def routed(fn):
    """``fn()``'s result and each MoE call's aux, its routing in it."""
    from repro_torch.models import blocks
    inner, records = blocks.moe_apply, []

    def recording(*args, **kwargs):
        y, aux = inner(*args, **kwargs)
        records.append(aux)
        return y, aux

    blocks.moe_apply = recording
    try:
        return fn(), records
    finally:
        blocks.moe_apply = inner


def split_fns(cfg, model, params, codec_name, seq):
    """``launch.serve.build_split``'s tuple, batch 1 and one edge segment,
    for a config no arch id names (one cut in depth)."""
    import torch
    from repro_torch.core.wire import get_codec
    edge_p, server_p = model.split_params(params, 1)
    codec = get_codec(codec_name)

    @torch.inference_mode()
    def edge_fn(tokens):
        return codec.encode(model.edge_forward(edge_p, tokens))

    @torch.inference_mode()
    def server_fn(payload):
        return model.server_forward(
            server_p, codec.decode(payload, dtype=cfg.torch_dtype))

    @torch.inference_mode()
    def mono_fn(tokens):
        return model.forward(params, tokens)[0]
    return (cfg, edge_fn, server_fn, mono_fn, None,
            codec.wire_bytes((1, seq, cfg.d_model)), seq * 4)


def decoder_full_width(name, cfg, model, k5_want, dev, gen, reset_counts,
                       counts, *, arch=None, say=print, f32_prompt=None,
                       extra=None):
    """One decoder at full width, drawn on the card from seed 0 (every
    tensor it makes is freed when it returns): (a) one split decision
    (``launch.serve.build_split`` for ``arch``, else :func:`split_fns`;
    uint8 codec, 1 x 128 tokens): edge, server and monolith ms by the host
    clock and CUDA events, a traced decision's kernels and busy share, the
    weights' bytes bound, K5's launches (``k5_want``, all on the tensor
    cores, none copied), and the float32 codec's split against the
    monolith; ``extra(params, prompt)``, where given, adds its own checks'
    dict as ``row["extra"]``; (b) the prompt decoded one token at a time
    into a 256-deep bf16 cache against the bf16 forward (the MoE's at a
    capacity that drops nothing), then 32 greedy tokens: ms, a traced step's
    kernels and busy share, and the bytes bound a token; then the
    parameters cast to f32 in place, the f32 forward, and the prompt's
    first ``f32_prompt`` tokens (all of them by default) decoded over an
    f32 cache against it; an
    MoE's routing compared between the bf16 and f32 forwards.  Returns the
    row."""
    import gc
    import torch
    from repro_torch.benchmarks.lm_split import timed, trace_decision
    from repro_torch.core.wire import get_codec
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn.module import (param_bytes, param_count, tree_leaves,
                                       tree_map)

    P, MAX, NEW = DEC_PROMPT, DEC_MAX, DEC_NEW
    f32_prompt = P if f32_prompt is None else f32_prompt

    def max_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    torch.cuda.synchronize()
    t_arch = time.perf_counter()
    row = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = serve_cli.init_params(model, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params, w_bytes = param_count(params), param_bytes(params)
    say(f"{name} full width ({cfg.n_layers} layers {cfg.blocks()[:3]}..., d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.mlp}, {cfg.norm}, qkv_bias "
        f"{cfg.qkv_bias}, bf16): {n_params} parameters, {w_bytes} B, drawn "
        f"on the card from seed 0 in {init_s:.2f} s; init's peak "
        f"{init_peak} B above the {base} B held before it = "
        f"{init_peak / w_bytes:.4f}x the parameters' bytes (limit "
        f"{FAM_INIT_PEAK}x)")
    check(init_peak <= FAM_INIT_PEAK * w_bytes,
          f"{name}: init's peak {init_peak} B over {FAM_INIT_PEAK}x the "
          f"parameters' {w_bytes} B")

    # ---- (a) one split decision --------------------------------------------
    def split(codec_name):
        if arch is None:
            return split_fns(cfg, model, params, codec_name, P)
        return serve_cli.build_split(arch, reduced=False, edge_segments=1,
                                     codec_name=codec_name, batch=1, seq=P,
                                     params=params)
    built = split("uint8")
    edge_fn, server_fn, mono_fn, wire, raw = built[1:4] + built[5:]
    del built
    prompt = torch.randint(3, cfg.vocab, (1, P), generator=gen(13)) \
        .to(dev, torch.int32)
    reset_counts()
    payload = edge_fn(prompt)
    logits = server_fn(payload)
    torch.cuda.synchronize()
    dec_counts = counts()
    tc, copies = flash_attention.tc_launches, flash_attention.copies
    reset_counts()
    mono = mono_fn(prompt)
    torch.cuda.synchronize()
    mono_counts = counts()
    check(dec_counts == (0, 0, 0, 0, k5_want) and mono_counts == dec_counts
          and tc == k5_want and copies == 0,
          f"{name}: a split decision launched K1..K5 {dec_counts} ({tc} on "
          f"the tensor cores, {copies} input copies), the monolith "
          f"{mono_counts}; expected (0, 0, 0, 0, {k5_want}), all on the "
          f"tensor cores, none copied")
    check(logits.shape == (1, P, cfg.vocab) and logits.dtype == torch.bfloat16
          and torch.isfinite(logits.float()).all()
          and payload["data"].dtype == torch.uint8
          and wire == get_codec("uint8").wire_bytes((1, P, cfg.d_model)),
          f"{name}: logits {logits.dtype} {tuple(logits.shape)}, payload "
          f"{payload['data'].dtype}, wire {wire} B")
    # the server half leaves a logit softcap out, as the reference's
    top1_split = (model._softcap(logits).argmax(-1) == mono.argmax(-1)) \
        .float().mean().item()
    times = {}
    for key, fn, arg in (("edge", edge_fn, prompt),
                         ("server", server_fn, payload),
                         ("monolith", mono_fn, prompt)):
        times[f"{key}_ms"], times[f"{key}_cpu_ms"] = timed(fn, arg, iters=5)
        times[f"{key}_event_ms"] = cuda_ms(lambda: fn(arg), iters=3,
                                           warmup=1)
    tr = trace_decision(lambda: server_fn(edge_fn(prompt)))
    busy = None if not tr["kernels"] else tr["busy_ms"] / tr["traced_wall_ms"]
    bound_ms = w_bytes / PEAK_BYTES_S * 1e3
    built = split("float32")
    split32 = model._softcap(built[2](built[1](prompt)))
    del built
    torch.cuda.synchronize()
    bitwise = torch.equal(split32, mono)
    say(f"{name} split@1 codec=uint8, 1x{P} tokens: K1..K5 launches "
        f"{dec_counts} a decision ({tc} on the tensor cores, {copies} copies;"
        f" the monolith {mono_counts}); logits {tuple(logits.shape)} finite, "
        f"top-1 agreement with the monolith {top1_split:.4f}; edge "
        f"{times['edge_ms']:.4f} ms server {times['server_ms']:.4f} ms "
        f"monolith {times['monolith_ms']:.4f} ms by the host clock (thread "
        f"CPU {times['edge_cpu_ms']:.4f} / {times['server_cpu_ms']:.4f} / "
        f"{times['monolith_cpu_ms']:.4f}), CUDA events "
        f"{times['edge_event_ms']:.4f} / {times['server_event_ms']:.4f} / "
        f"{times['monolith_event_ms']:.4f} ms; wire {wire} B raw {raw} B; a "
        f"traced decision {tr['kernels']} kernels, device busy "
        f"{tr['busy_ms']:.4f} ms of {tr['traced_wall_ms']:.4f} ms ("
        + ("not measured" if busy is None else f"{100 * busy:.2f}%")
        + f"); weights' bytes bound {bound_ms:.4f} ms; float32 codec: split "
        f"bit for bit the monolith {bitwise} (max_abs_err "
        f"{max_err(split32, mono):.3g})")
    say("  top kernels: " + "; ".join(f"{k[:60]} x{n} {ms:.4f} ms"
                                      for k, n, ms in tr["top"]))
    check(bitwise, f"{name}: the float32-codec split differs from the "
          f"monolith by {max_err(split32, mono)}")
    row["decision"] = dict(
        params=n_params, weight_bytes=w_bytes, init_s=init_s,
        init_peak_bytes=init_peak, launches=list(dec_counts), tc_launches=tc,
        copies=copies, top1_vs_monolith=top1_split, wire=wire, raw=raw,
        **times, traced_kernels=tr["kernels"], traced_busy_ms=tr["busy_ms"],
        traced_wall_ms=tr["traced_wall_ms"], busy_share=busy, top=tr["top"],
        bound_ms=bound_ms, f32_split_bitwise=bitwise)
    if extra is not None:
        row["extra"] = extra(params, prompt)
    # the split halves hold views of the bf16 leaves: drop them all before
    # the cast below frees those leaves
    del edge_fn, server_fn, mono_fn, payload, logits, split32

    # ---- (b) decode over a bf16 cache, then in f32 -------------------------
    def decode_prompt(m, p, dtype, n):
        c = m.init_cache(1, MAX, dtype, device=dev)
        i = torch.zeros((), dtype=torch.int64, device=dev)
        out = []
        for t in range(n):
            lg, c = m.decode_step(p, prompt[:, t:t + 1], c, i)
            i += 1
            out.append(lg)
        return torch.cat(out, 1), c

    reset_counts()
    dec, caches = decode_prompt(model, params, torch.bfloat16, P)
    torch.cuda.synchronize()
    decode_counts = counts()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    drops = pairs = trace_full = None
    oracle_cfg = cfg if cfg.moe is None else ample(cfg)
    if cfg.moe is not None:
        with torch.inference_mode():
            full, trace_full = routed(lambda: DecoderModel(oracle_cfg)
                                      .forward(params, prompt)[0])
            check(all(bool(r["keep"].all()) for r in trace_full),
                  f"{name}: the forward at capacity C = G dropped pairs")
            _, trace = routed(lambda: model.forward(params, prompt))
        drops = sum(int((~r["keep"]).sum()) for r in trace)
        pairs = sum(r["keep"].numel() for r in trace)
        del trace
    else:
        full = mono

    def greedy(c):
        i = torch.full((), P, dtype=torch.int64, device=dev)
        tok = dec[:, -1:].argmax(-1).to(torch.int32)
        toks = []
        for _ in range(NEW):
            lg, c = model.decode_step(params, tok, c, i)
            i += 1
            toks.append(tok)
            tok = lg.argmax(-1).to(torch.int32)
        return torch.cat(toks, 1)

    after_prompt = tree_map(lambda t: t.clone(), caches)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    toks = greedy(caches)
    ev1.record()
    ev1.synchronize()
    tok_host_ms = (time.perf_counter() - t0) * 1e3 / NEW
    tok_ev_ms = ev0.elapsed_time(ev1) / NEW
    peak = torch.cuda.max_memory_allocated()
    i3 = torch.full((), P, dtype=torch.int64, device=dev)
    trd = trace_decision(lambda: model.decode_step(params, toks[:, :1],
                                                   after_prompt, i3))
    busy_d = (None if not trd["kernels"]
              else trd["busy_ms"] / trd["traced_wall_ms"])
    tok_bound = (w_bytes + cache_bytes) / PEAK_BYTES_S * 1e3
    del caches, after_prompt, mono

    # the f32 copy, cast leaf by leaf in place (qwen2.5-14b's 59 GB of f32
    # fit beside no second copy), decoded over an f32 cache
    gc.collect()
    params32 = cast_in_place(params, torch.float32)
    del params
    model32 = DecoderModel(dataclasses.replace(oracle_cfg, dtype="float32"))
    with torch.inference_mode():
        full32, trace32 = routed(lambda: model32.forward(params32,
                                                         prompt)[0])
    dec32, _ = decode_prompt(model32, params32, torch.float32, f32_prompt)
    del params32
    err32 = max_err(dec32, full32[:, :f32_prompt])
    top1_32 = (dec32.argmax(-1) == full32[:, :f32_prompt].argmax(-1)) \
        .float().mean().item()
    err = max_err(dec, full)
    top1 = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    err_truth = max_err(dec, full32)
    floor = max_err(full, full32)
    top1_truth = (dec.argmax(-1) == full32.argmax(-1)).float().mean().item()
    top1_floor = (full.argmax(-1) == full32.argmax(-1)).float().mean().item()
    routing = None
    if trace_full is not None:
        # the tokens whose experts differ between the bf16 and f32
        # forwards in any layer, and the bf16 forward's distance from the
        # f32 one at those tokens and at the others
        flip = torch.zeros(P, dtype=torch.bool, device=dev)
        for a, b in zip(trace_full, trace32):
            flip |= (a["expert_idx"].reshape(P, -1)
                     != b["expert_idx"].reshape(P, -1)).any(-1)
        by_pos = (full.float() - full32.float()).abs().amax(-1)[0]
        routing = dict(
            layers=len(trace32), flipped_tokens=int(flip.sum()),
            floor_flipped=(by_pos[flip].max().item() if flip.any()
                           else None),
            floor_unflipped=(by_pos[~flip].max().item() if not flip.all()
                             else None))
        check(len(trace_full) == len(trace32) == cfg.n_layers,
              f"{name}: {len(trace_full)} and {len(trace32)} MoE layers "
              f"routed")
    say(f"{name} decode B=1, {P} prompt tokens one at a time into a "
        f"{MAX}-deep bf16 cache ({cache_bytes} B; recurrent states f32), "
        f"against the forward"
        + (" at capacity_factor = n_experts / top_k (the default forward "
           f"drops {drops} of {pairs} (token, k) pairs)"
           if drops is not None else "")
        + f": f32 model and cache, the first {f32_prompt} tokens, "
        f"max_abs_err {err32:.4g} (tol {LM_DECODE_TOL}), top-1 "
        f"{top1_32:.4f} (limit {FAM_TOP1}); bf16 max_abs_err {err:.4g}, "
        f"top-1 {top1:.4f} against the bf16 forward; {err_truth:.4g} and "
        f"top-1 {top1_truth:.4f} against the f32 forward, where the bf16 "
        f"forward is {floor:.4g} and {top1_floor:.4f} (limit "
        f"{LM_BF16_FLOOR}x)"
        + ("" if routing is None else
           f"; the bf16 and f32 forwards route {routing['flipped_tokens']} of"
           f" {P} tokens to another expert in at least one of "
           f"{routing['layers']} layers, the bf16 forward "
           f"{routing['floor_flipped']} from the f32 one at those tokens "
           f"and {routing['floor_unflipped']} at the others")
        + f"; K1..K5 launches while decoding {decode_counts}; {NEW} greedy "
        f"tokens {toks[0].tolist()}; {tok_ev_ms:.4f} ms a token by CUDA "
        f"events, {tok_host_ms:.4f} ms by the host clock; a traced step "
        f"{trd['kernels']} kernels, busy {trd['busy_ms']:.4f} ms of "
        f"{trd['traced_wall_ms']:.4f} ms ("
        + ("not measured" if busy_d is None else f"{100 * busy_d:.2f}%")
        + f"); bytes bound {tok_bound:.4f} ms a token (weights + cache "
        f"once); peak device memory {peak} B")
    check(decode_counts == (0,) * 5, f"{name}: decoding launched K1..K5 "
          f"{decode_counts}")
    check(err32 <= LM_DECODE_TOL and top1_32 >= FAM_TOP1,
          f"{name}: f32 decode differs from the forward by {err32} (tol "
          f"{LM_DECODE_TOL}), top-1 {top1_32} (limit {FAM_TOP1})")
    check(err_truth <= LM_BF16_FLOOR * floor,
          f"{name}: bf16 decode is {err_truth} from the f32 forward, more "
          f"than {LM_BF16_FLOOR} x the bf16 forward's {floor}")
    row["decode"] = dict(
        prompt=P, new_tokens=NEW, cache_len=MAX, cache_bytes=cache_bytes,
        f32_prompt=f32_prompt, f32_max_abs_err=err32, f32_top1=top1_32,
        tol=LM_DECODE_TOL, bf16_max_abs_err=err, bf16_top1=top1,
        bf16_vs_f32_err=err_truth, bf16_vs_f32_top1=top1_truth,
        bf16_forward_vs_f32_err=floor, bf16_forward_vs_f32_top1=top1_floor,
        floor_limit=LM_BF16_FLOOR, forward_drops=drops, forward_pairs=pairs,
        routing=routing, launches=list(decode_counts),
        greedy_tokens=toks[0].tolist(), ms_per_token_events=tok_ev_ms,
        ms_per_token_host=tok_host_ms, traced_kernels=trd["kernels"],
        traced_busy_ms=trd["busy_ms"], traced_wall_ms=trd["traced_wall_ms"],
        busy_share=busy_d, top=trd["top"], bound_ms_per_token=tok_bound,
        peak_bytes=peak)
    row["seconds"] = time.perf_counter() - t_arch
    say(f"{name}: {row['seconds']:.2f} s")
    return row


def families_phase(dev, gen, reset_counts, counts):
    """Phase 17: the MoE, SSM and RG-LRU families at full width.  For each
    of mamba2-130m, recurrentgemma-9b and qwen2-moe-a2.7b, from seed 0 on
    the card, :func:`decoder_full_width`'s (a) one split decision through
    ``launch.serve.build_split`` and (b) a 128-token prompt decoded into a
    bf16 cache and in f32 against the forward, then 32 greedy tokens; (c)
    each family's 2-layer f32 ``reduced()`` config card against CPU; (d) K5
    held at the
    MoE's shape, (1,16/16,128,128) bf16 views, against its plain version;
    (e) ``launch.train --arch mamba2-130m --full`` for 24 steps at batch 4 x
    256 (past the 20-step warmup; it must exit 0, the loss fallen), and
    one step's gradients card against CPU at 2 full-width f32 layers.
    Returns the ``{"families": ...}`` dict."""
    import gc
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn.module import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    fam = {}

    def max_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    for arch, k5_want in FAMILIES:
        cfg, model = get_model(arch, reduced=False)
        check(cfg == get_config(arch) and cfg.dtype == "bfloat16",
              f"{arch}: not its published config")
        fam[arch] = decoder_full_width(arch, cfg, model, k5_want, dev, gen,
                                       reset_counts, counts, arch=arch)
        del model
        gc.collect()
        torch.cuda.empty_cache()

    # ---- (c) the card against the CPU, 2-layer f32 reduced() configs -------
    for arch, _ in FAMILIES:
        cfg_r = get_config(arch).reduced()
        model_r = DecoderModel(cfg_r)
        p_cpu = model_r.init(gen(31), device="cpu")
        p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
        tok = torch.randint(3, cfg_r.vocab, (1, 64), generator=gen(32)) \
            .to(torch.int32)
        with torch.inference_mode():
            (fc, ac), rc = routed(lambda: model_r.forward(p_cpu, tok))
            (fg, ag), rg = routed(lambda: model_r.forward(p_gpu,
                                                          tok.to(dev)))

        def decode16(p, device):
            c = model_r.init_cache(1, 16, torch.float32, device=device)
            out = []
            for t in range(16):
                lg, c = model_r.decode_step(p, tok[:, t:t + 1].to(device), c,
                                            t)
                out.append(lg)
            return torch.cat(out, 1)

        dc, dg = decode16(p_cpu, "cpu"), decode16(p_gpu, dev).cpu()
        e_fwd = max_err(fg.cpu(), fc) / fc.abs().max().item()
        e_dec = max_err(dg, dc) / dc.abs().max().item()
        e_aux = abs(float(ag["moe_aux_loss"]) - float(ac["moe_aux_loss"]))
        same_idx = all(torch.equal(a["expert_idx"].cpu(), b["expert_idx"])
                       for a, b in zip(rg, rc)) and len(rg) == len(rc)
        line = (f"{arch} card vs CPU, reduced f32 ({cfg_r.n_layers} layers "
                f"{cfg_r.blocks()}, d {cfg_r.d_model}) at (1,64): forward "
                f"logits {e_fwd:.3g} of their largest, 16 decode steps "
                f"{e_dec:.3g} (tol {FAM_CPU_TOL})")
        if cfg_r.moe is not None:
            line += (f"; expert indices of {len(rc)} layers equal "
                     f"{same_idx}, moe_aux_loss {float(ag['moe_aux_loss']):.6f}"
                     f" differs by {e_aux:.3g} (tol {FAM_AUX_TOL})")
            if not same_idx:
                s = torch.sort(rc[0]["probs"], -1, descending=True).values
                k = cfg_r.moe.top_k
                line += (f"; smallest top-k margin on the CPU "
                         f"{(s[..., :k] - s[..., 1:k + 1]).min().item():.3g}")
        print(line)
        check(e_fwd <= FAM_CPU_TOL and e_dec <= FAM_CPU_TOL,
              f"{arch} reduced: card vs CPU forward {e_fwd}, decode {e_dec}")
        check(cfg_r.moe is None or (same_idx and e_aux <= FAM_AUX_TOL),
              f"{arch} reduced: expert indices equal {same_idx}, aux loss "
              f"{e_aux}")
        fam[arch]["card_vs_cpu"] = dict(forward_err=e_fwd, decode_err=e_dec,
                                        tol=FAM_CPU_TOL, aux_err=e_aux,
                                        expert_idx_equal=same_idx)
        del p_cpu, p_gpu

    # ---- (d) K5 at the MoE's shape -----------------------------------------
    q, k, v = (torch.randn((1, 128, 16, 128), generator=gen(50 + i))
               .to(dev, torch.bfloat16).transpose(1, 2) for i in range(3))
    reset_counts()
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    k5_counts = counts()
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    k5_err = max_err(got, want)
    ms_reps = [cuda_ms(lambda: flash_attention(q, k, v, causal=True))
               for _ in range(5)]
    k5_ms = median(ms_reps)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    flops = 4 * 128 * attention_pairs(128, None) * 16
    b_ms, b_by = bound(nbytes(q, k, v, got), flops, PEAK_BF16_FLOP_S)
    print(f"K5 flash_attention at qwen2-moe-a2.7b's shape (1,16/16 heads,"
          f"128,128) bf16 as (B,S,H,D) views: launches {k5_counts[4]}, "
          f"max_abs_err {k5_err:.3g} (tol {ATTN_TOL['bfloat16']}, vs plain in "
          f"f32); kernel {k5_ms:.4f} ms (median of "
          + "/".join(f"{t:.4f}" for t in ms_reps)
          + f"), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
          f"(scaled_dot_product_attention), bound {b_ms:.5f} ms ({b_by})")
    check(k5_counts == (0, 0, 0, 0, 1) and torch.isfinite(got.float()).all()
          and k5_err <= ATTN_TOL["bfloat16"],
          f"K5 at the MoE's shape: launches {k5_counts}, error {k5_err}")
    k5_moe = dict(shape=[1, 16, 128, 128], kv_heads=16, dtype="bfloat16",
                  views=True, max_abs_err=k5_err, ms=k5_ms, ms_reps=ms_reps,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                  bound_by=b_by,
                  decision_launches=fam["qwen2-moe-a2.7b"]["decision"][
                      "launches"][4])
    del q, k, v, got, want

    # ---- (e) mamba2-130m training -------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--full", "--arch", "mamba2-130m", "--steps", "24", "--batch",
            "4", "--seq", "256", "--device", "cuda"]
    rep = {}
    reset_counts()
    t0 = time.perf_counter()
    rc_train = train_cli.main(argv, report=rep)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    hist = rep["history"]
    losses = [h["loss"] for h in hist]
    first, last = hist[0], hist[-1]
    step_ms = ((last["wall_s"] - first["wall_s"])
               / (last["step"] - first["step"]) * 1e3)
    tokens_s = 4 * 256 / (step_ms / 1e3)
    del rep

    cfg_t = dataclasses.replace(get_config("mamba2-130m"), n_layers=2,
                                n_pattern=2, dtype="float32")
    model_t = DecoderModel(cfg_t)
    p_cpu = model_t.init(gen(41), device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    batch = next(lm_batches(cfg_t.vocab, 2, 256, seed=4, device="cpu"))

    def grads(p, device):
        b = {key: val.to(device) for key, val in batch.items()}
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = model_t.loss(tree_unflatten(p, leaves), b)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    l_g, g_g = grads(p_gpu, dev)
    l_c, g_c = grads(p_cpu, "cpu")
    names = [n for n, _ in tree_paths(p_cpu)]
    g_errs = {n: (a.cpu() - b).abs().max().item()
              / max(b.abs().max().item(), 1e-30)
              for n, a, b in zip(names, g_g, g_c)}
    worst = max(g_errs, key=g_errs.get)
    finite = all(torch.isfinite(g).all() for g in g_g)
    print(f"mamba2-130m training, launch.train {' '.join(argv)}: exit "
          f"{rc_train}; losses at steps {[h['step'] for h in hist]}: "
          f"{losses}; {step_ms:.4f} ms a step after the first "
          f"({tokens_s:.1f} tokens/s), first step "
          f"{first['wall_s'] * 1e3:.4f} ms; peak device memory {peak} B; "
          f"K1..K5 launches {train_counts}; {train_s:.2f} s.  One step card "
          f"vs CPU at 2 full-width f32 layers, batch (2,256): loss "
          f"{float(l_g):.6f} vs {float(l_c):.6f}; gradients finite "
          f"{finite}, worst {g_errs[worst]:.3g} of its leaf's largest "
          f"({worst}; tol {FAM_GRAD_TOL})")
    check(rc_train == 0 and all(math.isfinite(x) for x in losses),
          f"mamba2-130m launch.train --full exited {rc_train} with losses "
          f"{losses}")
    check(finite and g_errs[worst] <= FAM_GRAD_TOL,
          f"mamba2-130m step card vs CPU: gradients finite {finite}, worst "
          f"{g_errs[worst]} ({worst})")
    fam["mamba2-130m"]["train"] = dict(
        argv=argv, rc=rc_train, steps=[h["step"] for h in hist],
        losses=losses, ms_per_step=step_ms,
        first_step_ms=first["wall_s"] * 1e3, tokens_per_s=tokens_s,
        peak_bytes=peak, launches=list(train_counts), seconds=train_s,
        card_vs_cpu_loss_err=abs(float(l_g) - float(l_c)),
        card_vs_cpu_grad_err=g_errs[worst], grad_tol=FAM_GRAD_TOL)
    out = {"configs": fam, "k5_moe": k5_moe,
           "seconds": time.perf_counter() - t_phase}
    print(f"families phase: {out['seconds']:.2f} s (target 90 s)")
    return out


# Phase 18: Whisper's encoder-decoder and llava's prefill at full width.
# Tolerances: K5 at the new shapes against its plain version as in phase 8
# (ATTN_TOL); Whisper's decode against its teacher-forced decoder by phase
# 16's rule (f32 within LM_DECODE_TOL; bf16 within LM_BF16_FLOOR times the
# bf16 decoder's own distance from the f32 one); the reduced config card
# against CPU as in phase 17 (FAM_CPU_TOL of the largest; a step's
# gradients FAM_GRAD_TOL of each leaf's largest, the key biases', zero in
# exact arithmetic, below FAM_GRAD_TOL of the largest of all leaves).
WHISPER_PROMPT = 32     # decoder positions decoded one at a time
WHISPER_NEW = 32        # greedy tokens after them, twice
WHISPER_K5 = 24         # K5 launches an encode, and a decoder pass
LLAVA_TEXT = 128        # text tokens after llava's 2,880 patch tokens
LLAVA_K5 = 32           # K5 launches a llava prefill


def whisper_phase(dev, gen, reset_counts, counts):
    """Phase 18: the audio family and the VLM prefill at full width.  (a)
    K5 at Whisper's shapes, (1,16,1500,64) non-causal and (1,16,448,64)
    causal, as (B,S,H,D) views in f32 and bf16, against its plain version,
    timed beside ``scaled_dot_product_attention``; (b) whisper-medium from
    seed 0, bf16 on the card: 1,500 stub frames encoded (24 K5 launches on
    the tensor cores, no copy), the teacher-forced decoder at its 448
    positions (24 more), the cross cache, 32 prompt tokens decoded one at
    a time against the decoder's logits in bf16 and in f32, then 32 greedy
    tokens twice, bitwise; (c) the reduced config card against CPU; (d)
    ``launch.train --arch whisper-medium --full`` for 24 steps from (b)'s
    parameters (past the 20-step warmup; it must exit 0, the loss fallen)
    and a step's gradients card against CPU at reduced size; (e)
    llava-next-mistral-7b's prefill at full width, 2,880 stub patch
    embeddings and 128 text tokens (32 K5 launches), and K5 held at its
    (1,32/8,3008,128) shape.  Returns the ``{"whisper": ...}`` dict."""
    import gc
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks.lm_split import trace_decision
    from repro_torch.configs import get_config
    from repro_torch.data import frontend_batches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import get_model
    from repro_torch.models.whisper import WhisperModel
    from repro_torch.nn.attention import flash_blocks
    from repro_torch.nn.module import (cast_tree, param_bytes, param_count,
                                       tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    out = {"k5": {}}

    def max_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def k5_counts():
        return (counts(), flash_attention.tc_launches, flash_attention.copies)

    # ---- (a) K5 at Whisper's shapes ----------------------------------------
    def k5_case(label, H, H_kv, S, D, dt, causal, seed, iters):
        q, k, v = (torch.randn((1, S, n, D), generator=gen(seed + i))
                   .to(dev, dt).transpose(1, 2)
                   for i, n in enumerate((H, H_kv, H_kv)))
        n_rep = H // H_kv
        kr, vr = k.repeat_interleave(n_rep, 1), v.repeat_interleave(n_rep, 1)
        blk = flash_blocks(S)

        def run():
            return flash_attention(q, k, v, causal=causal, block_q=blk,
                                   block_k=blk)
        reset_counts()
        got, again = run(), run()
        torch.cuda.synchronize()
        launched = k5_counts()
        want = attention_ref(q.float(), kr.float(), vr.float(),
                             causal=causal)
        name = str(dt).removeprefix("torch.")
        tol = ATTN_TOL[name]
        err = max_err(got, want)
        tc = dt == torch.bfloat16
        check(launched == ((0, 0, 0, 0, 2), 2 * tc, 0),
              f"K5 {label}: launches, tensor-core launches, copies "
              f"{launched}; expected ((0, 0, 0, 0, 2), {2 * tc}, 0)")
        check(got.dtype == dt and got.shape == q.shape
              and torch.isfinite(got.float()).all()
              and torch.allclose(got.float(), want, atol=tol, rtol=tol),
              f"K5 {label}: differs from plain by {err} (tol {tol})")
        check(torch.equal(got, again), f"K5 {label}: two runs differ")
        ms_reps = [cuda_ms(run, iters=iters) for _ in range(5)]
        ms = median(ms_reps)
        plain_ms = cuda_ms(lambda: attention_ref(q, kr, vr, causal=causal),
                           iters=iters)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=n_rep > 1), iters=iters)
        dev_us = kernel_device_us(run, "flash_kernel", calls=iters)
        dev_us = dev_us and dev_us[0]
        pairs = attention_pairs(S, None) if causal else S * S
        flops = 4 * D * pairs * H
        b_ms, b_by = bound(nbytes(q, k, v, got), flops,
                           PEAK_BF16_FLOP_S if tc else PEAK_FP32_FLOP_S)
        t_ms = ms if dev_us is None else dev_us / 1e3
        print(f"K5 flash_attention {label} (1,{H}/{H_kv} heads,{S},{D}) "
              f"{name} {'causal' if causal else 'non-causal'} as (B,S,H,D) "
              f"views, blocks {blk}, {'tensor' if tc else 'CUDA'}-core "
              f"route: max_abs_err {err:.3g} (tol {tol}, vs plain in f32), "
              f"repeats bit for bit; kernel {ms:.4f} ms (device "
              + ("not measured" if dev_us is None else f"{dev_us:.2f} us")
              + " a launch, traced; median of "
              + "/".join(f"{t:.4f}" for t in ms_reps)
              + f"), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"(scaled_dot_product_attention), bound {b_ms:.5f} ms ({b_by}, "
              f"{flops / 1e9:.4g} GFLOP); {flops / t_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * b_ms / t_ms:.2f}% of the bound")
        out["k5"][label] = dict(
            shape=[1, H, S, D], kv_heads=H_kv, dtype=name, causal=causal,
            views=True, max_abs_err=err, ms=ms, ms_reps=ms_reps,
            device_us=dev_us, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by, tflops=flops / t_ms / 1e9,
            bound_share=b_ms / t_ms, tensor_cores=tc)

    for idx, (label, S, dt, causal, iters) in enumerate((
            ("whisper encoder", 1500, torch.bfloat16, False, 20),
            ("whisper encoder f32", 1500, torch.float32, False, 5),
            ("whisper decoder", 448, torch.bfloat16, True, 50),
            ("whisper decoder f32", 448, torch.float32, True, 20))):
        k5_case(label, 16, 16, S, 64, dt, causal, 600 + 3 * idx, iters)
    torch.cuda.empty_cache()

    # ---- (b) whisper-medium at full width ---------------------------------
    P, NEW = WHISPER_PROMPT, WHISPER_NEW
    cfg, model = get_model("whisper-medium")
    dims = (cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.n_frontend_tokens)
    check(isinstance(model, WhisperModel)
          and cfg == get_config("whisper-medium") and cfg.dtype == "bfloat16"
          and dims == (24, 24, 1024, 16, 64, 1500),
          f"not whisper-medium: {cfg}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = serve_cli.init_params(model, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    n_params, w_bytes = param_count(params), param_bytes(params)
    frames = next(frontend_batches(1, cfg.n_frontend_tokens, cfg.d_model,
                                   device=dev))
    tokens = torch.randint(3, cfg.vocab, (1, model.max_target_positions),
                           generator=gen(13)).to(dev, torch.int32)

    def encode(m, p):
        with torch.inference_mode():
            return m.encode(p, frames)

    reset_counts()
    enc = encode(model, params)
    torch.cuda.synchronize()
    enc_counts = k5_counts()
    reset_counts()
    with torch.inference_mode():
        full = model.decode_full(params, tokens, enc)[0]
    torch.cuda.synchronize()
    full_counts = k5_counts()
    want = ((0, 0, 0, 0, WHISPER_K5), WHISPER_K5, 0)
    check(enc_counts == want and full_counts == want,
          f"whisper-medium: the encode launched (K1..K5, tensor-core, "
          f"copies) {enc_counts}, the decoder {full_counts}; expected {want}")
    check(enc.shape == (1, cfg.n_frontend_tokens, cfg.d_model)
          and torch.isfinite(enc.float()).all()
          and full.shape == (1, model.max_target_positions, cfg.vocab)
          and torch.isfinite(full.float()).all(),
          f"whisper-medium: bad encoder output {tuple(enc.shape)} or logits "
          f"{tuple(full.shape)}")
    encode_ms = cuda_ms(lambda: encode(model, params), iters=5, warmup=1)
    t0 = time.perf_counter()
    for _ in range(5):
        encode(model, params)
    torch.cuda.synchronize()
    encode_host_ms = (time.perf_counter() - t0) / 5 * 1e3

    def decode_prompt(m, p, e, dtype):
        c = m.prefill_cross_cache(p, e, m.init_cache(
            1, m.max_target_positions, dtype, device=dev))
        i = torch.zeros((), dtype=torch.int64, device=dev)
        lgs = []
        for t in range(P):
            lg, c = m.decode_step(p, tokens[:, t:t + 1], c, i)
            i += 1
            lgs.append(lg)
        return torch.cat(lgs, 1), c

    reset_counts()
    dec, caches = decode_prompt(model, params, enc, torch.bfloat16)
    torch.cuda.synchronize()
    decode_counts = counts()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    check(all(t.dtype == torch.bfloat16 for t in tree_leaves(caches)),
          "whisper-medium: a cache is not bf16")
    after_prompt = tree_map(lambda t: t.clone(), caches)

    def greedy(c):
        i = torch.full((), P, dtype=torch.int64, device=dev)
        tok = dec[:, -1:].argmax(-1).to(torch.int32)
        toks, lgs = [], []
        for _ in range(NEW):
            lg, c = model.decode_step(params, tok, c, i)
            i += 1
            toks.append(tok)
            lgs.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        return torch.cat(toks, 1), torch.cat(lgs, 1), c

    c1 = tree_map(lambda t: t.clone(), after_prompt)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    toks1, lg1, c1 = greedy(c1)
    ev1.record()
    ev1.synchronize()
    tok_host_ms = (time.perf_counter() - t0) * 1e3 / NEW
    tok_ev_ms = ev0.elapsed_time(ev1) / NEW
    toks2, lg2, c2 = greedy(tree_map(lambda t: t.clone(), after_prompt))
    torch.cuda.synchronize()
    repeat = (torch.equal(toks1, toks2) and torch.equal(lg1, lg2)
              and all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(c1), tree_leaves(c2))))
    i3 = torch.full((), P, dtype=torch.int64, device=dev)
    tr = trace_decision(lambda: model.decode_step(params, toks1[:, :1],
                                                  after_prompt, i3))
    busy = (None if not tr["kernels"]
            else tr["busy_ms"] / tr["traced_wall_ms"])
    tok_bound = (w_bytes + cache_bytes) / PEAK_BYTES_S * 1e3
    del c1, c2, caches, lg1, lg2

    # the f32 copy (3 GB beside the bf16 parameters), over an f32 self cache
    # (the cross cache is bf16 whatever the model's dtype)
    params32 = cast_tree(params, torch.float32)
    model32 = WhisperModel(dataclasses.replace(cfg, dtype="float32"))
    enc32 = encode(model32, params32)
    with torch.inference_mode():
        full32 = model32.decode_full(params32, tokens, enc32)[0]
    dec32, _ = decode_prompt(model32, params32, enc32, torch.float32)
    err32 = max_err(dec32, full32[:, :P])
    top1_32 = (dec32.argmax(-1) == full32[:, :P].argmax(-1)).float() \
        .mean().item()
    err = max_err(dec, full[:, :P])
    top1 = (dec.argmax(-1) == full[:, :P].argmax(-1)).float().mean().item()
    err_truth = max_err(dec, full32[:, :P])
    floor = max_err(full[:, :P], full32[:, :P])
    print(f"whisper-medium full width (24 + 24 layers, d 1024, 16 heads, "
          f"head_dim 64, vocab 51865, bf16): {n_params} parameters in the "
          f"tree ({cfg.param_count()} by ArchConfig.param_count, which "
          f"leaves out cross-attention, biases, norms and the position "
          f"table, as the reference's), {w_bytes} B, drawn on the card in "
          f"{init_s:.2f} s, init's peak {init_peak / w_bytes:.4f}x the "
          f"parameters' bytes; encode of 1x{cfg.n_frontend_tokens} frames: "
          f"(K1..K5, tensor-core, copies) {enc_counts}, {encode_ms:.4f} ms "
          f"by CUDA events, {encode_host_ms:.4f} ms by the host clock; the "
          f"teacher-forced decoder at {model.max_target_positions} positions "
          f"{full_counts}; {P} prompt tokens decoded one at a time over a "
          f"{model.max_target_positions}-deep bf16 self cache and the bf16 "
          f"cross cache ({cache_bytes} B): f32 max_abs_err {err32:.4g} "
          f"against the f32 decoder (tol {LM_DECODE_TOL}), top-1 "
          f"{top1_32:.4f}; bf16 {err:.4g} against the bf16 decoder, top-1 "
          f"{top1:.4f}, {err_truth:.4g} against the f32 decoder where the "
          f"bf16 decoder is {floor:.4g} from it (limit {LM_BF16_FLOOR}x); "
          f"K1..K5 launches while decoding {decode_counts}; {NEW} greedy "
          f"tokens {toks1[0].tolist()}, twice bitwise equal {repeat}; "
          f"{tok_ev_ms:.4f} ms a token by CUDA events, {tok_host_ms:.4f} ms "
          f"by the host clock; a traced step {tr['kernels']} kernels, busy "
          f"{tr['busy_ms']:.4f} ms of {tr['traced_wall_ms']:.4f} ms ("
          + ("not measured" if busy is None else f"{100 * busy:.2f}%")
          + f"); bytes bound {tok_bound:.4f} ms a token (weights + caches "
          f"once); top: " + "; ".join(f"{k[:60]} x{n} {ms:.4f} ms"
                                      for k, n, ms in tr["top"]))
    check(decode_counts == (0,) * 5, f"whisper-medium: decoding launched "
          f"K1..K5 {decode_counts}")
    check(err32 <= LM_DECODE_TOL, f"whisper-medium: f32 decode differs "
          f"from the f32 decoder by {err32} (tol {LM_DECODE_TOL})")
    check(err_truth <= LM_BF16_FLOOR * floor,
          f"whisper-medium: bf16 decode is {err_truth} from the f32 "
          f"decoder, more than {LM_BF16_FLOOR} x the bf16 decoder's {floor}")
    check(repeat, "whisper-medium: the greedy continuation does not repeat "
          "bit for bit")
    out["model"] = dict(
        params=n_params, analytic_params=cfg.param_count(),
        weight_bytes=w_bytes, init_s=init_s, init_peak_bytes=init_peak,
        frames=cfg.n_frontend_tokens, encode_launches=list(enc_counts[0]),
        encode_tc_launches=enc_counts[1], encode_copies=enc_counts[2],
        decoder_launches=list(full_counts[0]),
        decoder_positions=model.max_target_positions,
        encode_ms_events=encode_ms, encode_ms_host=encode_host_ms,
        prompt=P, new_tokens=NEW, cache_bytes=cache_bytes,
        decode_launches=list(decode_counts), f32_max_abs_err=err32,
        f32_top1=top1_32, tol=LM_DECODE_TOL, bf16_max_abs_err=err,
        bf16_top1=top1, bf16_vs_f32_err=err_truth,
        bf16_decoder_vs_f32_err=floor, bf16_floor_limit=LM_BF16_FLOOR,
        greedy_tokens=toks1[0].tolist(), greedy_bitwise=repeat,
        ms_per_token_events=tok_ev_ms, ms_per_token_host=tok_host_ms,
        traced_kernels=tr["kernels"], traced_busy_ms=tr["busy_ms"],
        traced_wall_ms=tr["traced_wall_ms"], busy_share=busy,
        top=tr["top"], bound_ms_per_token=tok_bound)
    del params32, model32, enc32, full32, dec32, dec, full, enc
    del after_prompt

    # ---- (c) the card against the CPU, the 2 + 2-layer f32 reduced config -
    cfg_r = get_config("whisper-medium").reduced()
    model_r = WhisperModel(cfg_r)
    p_cpu = model_r.init(gen(31), device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    fr = torch.randn((2, cfg_r.n_frontend_tokens, cfg_r.d_model),
                     generator=gen(32)) * 0.02
    tok_r = torch.randint(3, cfg_r.vocab, (2, 64), generator=gen(33))

    def reduced_run(p, device, cross=None):
        """The decoder's logits, the bf16 cross cache and 16 decode
        steps; the steps read ``cross`` where it is given (the CPU's, bit
        for bit: an entry one bf16 step apart moves a logit by ~1e-5)."""
        with torch.inference_mode():
            e = model_r.encode(p, fr.to(device))
            lg = model_r.decode_full(p, tok_r.to(device), e)[0]
        c = model_r.prefill_cross_cache(p, e, model_r.init_cache(
            2, 16, torch.float32, device=device))
        own = {n: t.cpu() for n, t in c["cross"].items()}
        if cross is not None:
            c["cross"] = {n: t.to(device) for n, t in cross.items()}
        steps = torch.cat([model_r.decode_step(
            p, tok_r[:, t:t + 1].to(device), c, t)[0] for t in range(16)], 1)
        return lg.cpu(), own, steps.cpu()

    fc, xc, dc = reduced_run(p_cpu, "cpu")
    fg, xg, dg = reduced_run(p_gpu, dev, cross=xc)
    e_fwd = max_err(fg, fc) / fc.abs().max().item()
    e_dec = max_err(dg, dc) / dc.abs().max().item()
    # the bf16 cross caches, rounded from f32 values 1e-7 apart: within one
    # bf16 step (2^-7 relative) and 1e-5
    x_ok = all(torch.allclose(xg[n].float(), xc[n].float(), atol=1e-5,
                              rtol=2 ** -7) for n in ("k", "v"))
    x_flips = sum(int((xg[n] != xc[n]).sum()) for n in ("k", "v"))

    def grads(p, device):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = model_r.loss(tree_unflatten(p, leaves), {
            "tokens": tok_r[:, :32].to(device),
            "frontend_embeds": fr.to(device)})
        return loss.detach(), torch.autograd.grad(loss, leaves)

    reset_counts()
    l_g, g_g = grads(p_gpu, dev)
    torch.cuda.synchronize()
    step_counts = counts()
    l_c, g_c = grads(p_cpu, "cpu")
    g_floor = max(g.abs().max().item() for g in g_c)
    g_errs = {}
    for n, a, b in zip([n for n, _ in tree_paths(p_cpu)], g_g, g_c):
        if n.endswith("wk/bias"):   # zero in exact arithmetic
            g_errs[n] = max(a.abs().max().item(), b.abs().max().item()) \
                / g_floor
        else:
            g_errs[n] = (a.cpu() - b).abs().max().item() \
                / max(b.abs().max().item(), 1e-30)
    worst = max(g_errs, key=g_errs.get)
    finite = all(torch.isfinite(g).all() for g in g_g)
    print(f"whisper-medium card vs CPU, reduced f32 (2 + 2 layers, d "
          f"{cfg_r.d_model}, {cfg_r.n_frontend_tokens} frames) at (2,64): "
          f"teacher-forced logits {e_fwd:.3g} of their largest, 16 decode "
          f"steps over the CPU's cross cache {e_dec:.3g} (tol "
          f"{FAM_CPU_TOL}); the card's bf16 cross cache within a bf16 step "
          f"of the CPU's {x_ok} ({x_flips} entries differ); one step's loss "
          f"{float(l_g):.6f} vs {float(l_c):.6f}, gradients finite {finite}, "
          f"worst {g_errs[worst]:.3g} ({worst}; tol {FAM_GRAD_TOL}); K1..K5 "
          f"launches in the card's step {step_counts}")
    check(e_fwd <= FAM_CPU_TOL and e_dec <= FAM_CPU_TOL and x_ok,
          f"whisper reduced: card vs CPU decoder {e_fwd}, decode {e_dec}, "
          f"cross cache within a bf16 step {x_ok}")
    check(finite and g_errs[worst] <= FAM_GRAD_TOL
          and step_counts == (0,) * 5,
          f"whisper reduced step: gradients finite {finite}, worst "
          f"{g_errs[worst]} ({worst}), launches {step_counts}")
    out["card_vs_cpu"] = dict(
        decoder_err=e_fwd, decode_err=e_dec, tol=FAM_CPU_TOL,
        cross_within_bf16_step=x_ok, cross_entries_differ=x_flips,
        loss_err=abs(float(l_g) - float(l_c)), grad_err=g_errs[worst],
        grad_worst=worst, grad_tol=FAM_GRAD_TOL,
        step_launches=list(step_counts))
    del p_cpu, p_gpu, g_g, g_c

    # ---- (d) training at full width ----------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--full", "--arch", "whisper-medium", "--steps", "24", "--batch",
            "2", "--seq", "128", "--device", "cuda"]
    rep = {}
    reset_counts()
    t0 = time.perf_counter()
    rc_train = train_cli.main(argv, params=params, report=rep)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    hist = rep["history"]
    losses = [h["loss"] for h in hist]
    first, last = hist[0], hist[-1]
    step_ms = ((last["wall_s"] - first["wall_s"])
               / (last["step"] - first["step"]) * 1e3)
    tokens_s = 2 * 128 / (step_ms / 1e3)
    print(f"whisper-medium training, launch.train {' '.join(argv)} from "
          f"(b)'s parameters: exit {rc_train}; losses at steps "
          f"{[h['step'] for h in hist]}: {losses}; {step_ms:.4f} ms a step "
          f"after the first ({tokens_s:.1f} decoder tokens/s, "
          f"{2 * cfg.n_frontend_tokens / (step_ms / 1e3):.1f} frames/s), "
          f"first step {first['wall_s'] * 1e3:.4f} ms; peak device memory "
          f"{peak} B; K1..K5 launches {train_counts}; {train_s:.2f} s")
    check(rc_train == 0 and all(math.isfinite(x) for x in losses),
          f"whisper-medium launch.train --full exited {rc_train} with "
          f"losses {losses}")
    check(train_counts == (0,) * 5, f"training launched K1..K5 "
          f"{train_counts}; K5 has no backward pass")
    out["train"] = dict(
        argv=argv, rc=rc_train, steps=[h["step"] for h in hist],
        losses=losses, ms_per_step=step_ms,
        first_step_ms=first["wall_s"] * 1e3, tokens_per_s=tokens_s,
        peak_bytes=peak, launches=list(train_counts), seconds=train_s)
    del rep, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) llava-next-mistral-7b's prefill at full width ----------------
    cfg_l, model_l = get_model("llava-next-mistral-7b")
    check(cfg_l == get_config("llava-next-mistral-7b")
          and cfg_l.dtype == "bfloat16" and cfg_l.n_frontend_tokens == 2880,
          f"not llava-next-mistral-7b: {cfg_l}")
    t0 = time.perf_counter()
    params_l = serve_cli.init_params(model_l, dev)
    torch.cuda.synchronize()
    init_l_s = time.perf_counter() - t0
    n_l, bytes_l = param_count(params_l), param_bytes(params_l)
    patches = next(frontend_batches(1, cfg_l.n_frontend_tokens,
                                    cfg_l.d_model, seed=1, device=dev))
    text = torch.randint(3, cfg_l.vocab, (1, LLAVA_TEXT),
                         generator=gen(14)).to(dev, torch.int32)

    def prefill():
        with torch.inference_mode():
            return model_l.forward(params_l, text,
                                   frontend_embeds=patches)[0]

    reset_counts()
    logits_l = prefill()
    torch.cuda.synchronize()
    l_counts = k5_counts()
    S_l = cfg_l.n_frontend_tokens + LLAVA_TEXT
    want = ((0, 0, 0, 0, LLAVA_K5), LLAVA_K5, 0)
    check(l_counts == want, f"llava prefill launched (K1..K5, tensor-core, "
          f"copies) {l_counts}; expected {want}")
    check(logits_l.shape == (1, S_l, cfg_l.vocab)
          and torch.isfinite(logits_l.float()).all(),
          f"llava prefill: bad logits {tuple(logits_l.shape)}")
    del logits_l
    prefill_ms = cuda_ms(prefill, iters=3, warmup=1)
    tr_l = trace_decision(prefill)
    busy_l = (None if not tr_l["kernels"]
              else tr_l["busy_ms"] / tr_l["traced_wall_ms"])
    # the matmuls (every parameter but the embedding table's, two FLOP a
    # token) and the causal cores
    flops_l = (2 * (n_l - cfg_l.vocab * cfg_l.d_model) * S_l
               + 4 * cfg_l.head_dim * attention_pairs(S_l, None)
               * cfg_l.n_heads * cfg_l.n_layers)
    print(f"llava-next-mistral-7b full width (32 layers, d 4096, 32/8 "
          f"heads, head_dim 128, bf16): {n_l} parameters, {bytes_l} B, "
          f"drawn on the card in {init_l_s:.2f} s; prefill of "
          f"{cfg_l.n_frontend_tokens} stub patch embeddings + {LLAVA_TEXT} "
          f"text tokens (S = {S_l}): (K1..K5, tensor-core, copies) "
          f"{l_counts}, logits (1, {S_l}, {cfg_l.vocab}) finite; "
          f"{prefill_ms:.4f} ms by CUDA events ({flops_l:.4g} FLOP, "
          f"{flops_l / prefill_ms / 1e9:.1f} TFLOP/s); a traced prefill "
          f"{tr_l['kernels']} kernels, busy {tr_l['busy_ms']:.4f} ms of "
          f"{tr_l['traced_wall_ms']:.4f} ms ("
          + ("not measured" if busy_l is None else f"{100 * busy_l:.2f}%")
          + "); top: " + "; ".join(f"{k[:60]} x{n} {ms:.4f} ms"
                                   for k, n, ms in tr_l["top"]))
    out["llava"] = dict(
        params=n_l, weight_bytes=bytes_l, init_s=init_l_s,
        patch_tokens=cfg_l.n_frontend_tokens, text_tokens=LLAVA_TEXT,
        launches=list(l_counts[0]), tc_launches=l_counts[1],
        copies=l_counts[2], prefill_ms=prefill_ms, flops=flops_l,
        traced_kernels=tr_l["kernels"], traced_busy_ms=tr_l["busy_ms"],
        traced_wall_ms=tr_l["traced_wall_ms"], busy_share=busy_l,
        top=tr_l["top"])
    del params_l, patches
    gc.collect()
    torch.cuda.empty_cache()
    k5_case("llava prefill", cfg_l.n_heads, cfg_l.n_kv_heads, S_l,
            cfg_l.head_dim, torch.bfloat16, True, 650, 10)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"whisper phase: {out['seconds']:.2f} s (target 60 s)")
    return out


# Phase 19: the sharded LM step and its dry-run.  (a) The dry-run of the
# production meshes at full width runs in child processes (a fake process
# group cannot share a process with the card's real one): they start
# before phase 16 and run beside phases 16 to 18 on the host's other
# cores, and phase 19 waits for them.  (b) Qwen3-0.6B's train, prefill
# and decode steps run as DTensor steps on a 1x1 mesh (nccl, world size
# 1) at full width, each held against the unsharded model at the same
# parameters within SHARDED_RTOL of the largest value (bitwise is what
# is expected: the 1x1 mesh relabels a placement change in place of a
# collective's copy), and their counted FLOPs and bytes against the
# dry-run of the same step on a 1x1 fake mesh, exactly.
SHARDED_RTOL = 1e-6
SHARDED_ARCH = "qwen3-0.6b"
# (shape id, seq len, batch, overrides): train_4k's batch is cut to what
# one card holds with remat on, and its attention blocks span the whole
# 4,096 tokens, so the chunked core runs as one block (the same function
# in a thirtieth of the ops); prefill_32k at B = 1 (K5 at
# (1,16/8,32768,128)); decode_32k at B = 8 over a 32,768-deep cache
SHARDED_STEPS = (("train_4k", 4096, 2, {"attn_block_q": 4096,
                                        "attn_block_k": 4096}),
                 ("prefill_32k", 32768, 1, {}),
                 ("decode_32k", 32768, 8, {}))
SHARDED_K5 = 28          # K5 launches a Qwen3-0.6B prefill
# the full-width dry-run cells and pair C of launch.perf
DRYRUN_CELLS = (("--arch", SHARDED_ARCH, "--mesh", "single"),
                ("--arch", SHARDED_ARCH, "--shape", "train_4k", "--mesh",
                 "multi"),
                ("--arch", "llama4-scout-17b-a16e", "--shape", "train_4k",
                 "--mesh", "single"))
DRYRUN_TIMEOUT_S = 420


def _sharded_shape(shape_id, S, B):
    from repro_torch.configs import SHAPES
    from repro_torch.models.config import ShapeConfig
    return ShapeConfig(shape_id, S, B, SHAPES[shape_id].kind)


def sharded_dryrun(out_path) -> int:
    """``python3 chip_smoke.py --sharded-dryrun OUT``: the dry-run of each
    of ``SHARDED_STEPS`` on a 1x1 fake mesh (``launch.steps.trace_step``),
    its counts written to OUT as JSON for phase 19 to hold the card's
    counts against.  Runs in a process of its own."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import init_fake_group
    from repro_torch.launch.steps import trace_step
    torch.set_num_threads(1)
    init_fake_group(1)
    mesh = DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    out = {}
    for shape_id, S, B, over in SHARDED_STEPS:
        # repro: allow(timing-warmup) -- times a dry-run trace over meta DTensors on a fake process group: nothing runs on the device
        t0 = time.perf_counter()
        t = trace_step(SHARDED_ARCH, shape_id, mesh, overrides=over or None,
                       shape=_sharded_shape(shape_id, S, B))
        out[shape_id] = dict(dataclasses.asdict(t.counter),
                             trace_s=t.trace_s,
                             wall_s=time.perf_counter() - t0)
    Path(out_path).write_text(json.dumps(out))
    return 0


def start_dryrun(work: Path):
    """Start phase 19's dry-run children: the full-width cells through
    ``python -m repro_torch.launch.dryrun`` and ``launch.perf --pair C``
    one after another in one shell, and ``--sharded-dryrun``.  Returns
    (the Popen objects, their log paths, the rows' path, the 1x1 counts'
    path)."""
    import shlex
    work.mkdir(parents=True, exist_ok=True)
    rows, counts = work / "dryrun_rows.jsonl", work / "sharded_1x1.json"
    for p in (rows, counts):
        p.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    py = shlex.quote(sys.executable)
    out = shlex.quote(str(rows))
    cmds = [f"{py} -m repro_torch.launch.dryrun {' '.join(cell)} --out {out}"
            for cell in DRYRUN_CELLS]
    cmds.append(f"{py} -m repro_torch.launch.perf --pair C --out {out}")
    shell = "; ".join(f'{c}; echo "rc=$? {i}"' for i, c in enumerate(cmds))
    logs = [work / "dryrun.log", work / "sharded_1x1.log"]
    procs = []
    for cmd, log in ((["sh", "-c", shell], logs[0]),
                     ([sys.executable, str(ROOT / "chip_smoke.py"),
                       "--sharded-dryrun", str(counts)], logs[1])):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
    return procs, logs, rows, counts


def sharded_phase(dev, gen, reset_counts, counts, card, children):
    """Phase 19: (b) first, while the dry-run children may still run, then
    (a).  (a) waits for the children, prints each cell's row and renders
    the file with ``benchmarks.roofline_table``; (b) runs Qwen3-0.6B's
    train (S = 4,096, B = 2, remat), prefill (B = 1, S =
    32,768: K5 28 times at (1,16/8,32768,128)) and decode (B = 8 over a
    32,768-deep cache) steps as DTensor steps on a 1x1 nccl mesh at full
    width: the median step time (CUDA events, after a warm-up) beside the
    same step through the unsharded model, the counter's FLOPs and bytes
    beside the 1x1 dry-run's, the roofline terms and the MFU against 989
    TFLOP/s, and the peak memory beside the dry-run's; and K5 alone at
    (1,16/8,32768,128) beside the library and, on its first and last 512
    query rows, its plain f32 version.  Returns the ``{"sharded": ...}``
    dict."""
    import gc
    import io
    from contextlib import redirect_stdout
    import torch
    import torch.nn.functional as F
    from repro_torch.benchmarks import roofline_table
    from repro_torch.configs import get_config
    from repro_torch.costs import CostCounter
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch import roofline
    from repro_torch.launch.steps import _apply_overrides, make_step
    from repro_torch.models.registry import build_model
    from repro_torch.nn.module import (param_bytes, tree_leaves, tree_map,
                                       tree_unflatten)
    from repro_torch.train.optimizer import adamw
    from torch.utils._pytree import tree_leaves as pytree_leaves

    # repro: allow(timing-warmup) -- phase wall clock, first calls and builds included; the device results it checks before its end read synchronize
    t_phase = time.perf_counter()
    out = {"card": card}
    procs, logs, rows_path, counts_path = children

    def wait_child(proc, log, path):
        """The 1x1 dry-run's counts, once its child has exited 0."""
        try:
            proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        check(proc.returncode == 0,
              f"the 1x1 dry-run failed: {log.read_text()[-3000:]}")
        return json.loads(path.read_text())

    # ---- (b) the sharded steps on a 1x1 mesh at full width -----------------
    mesh = make_host_mesh(device=dev)
    cfg0 = get_config(SHARDED_ARCH)
    model = build_model(cfg0)
    params = model.init(gen(0), device=dev)
    torch.cuda.synchronize()
    check(cfg0.d_model == 1024 and cfg0.n_layers == 28
          and cfg0.vocab == 151936, f"not full width: {cfg0}")

    def timed(fn, reps=3):
        """(median ms of ``reps`` calls, the readings), each between CUDA
        events with the device synchronized; the caller has warmed ``fn``
        up."""
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return median(ts), ts

    def local(tree):
        return tree_map(lambda t: t.to_local(), tree)

    def rel_err(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    steps_out = {}
    fake = None     # the 1x1 dry-run's counts, read once its child is done
    for shape_id, S, B, over in SHARDED_STEPS:
        t_step = time.perf_counter()
        shape = _sharded_shape(shape_id, S, B)
        cfg, _ = _apply_overrides(cfg0, over or None)
        bundle = make_step(SHARDED_ARCH, shape_id, mesh,
                           overrides=over or None, shape=shape)
        plain_model = build_model(cfg)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=gen(90))
        toks = toks.to(dev, torch.int32)
        torch.cuda.empty_cache()
        if shape.kind == "train":
            opt = adamw(3e-4, clip_norm=1.0)
            ost = opt.init(params)
            args = (params, ost, {"tokens": toks})

            def plain():
                leaves = [x.detach().requires_grad_()
                          for x in tree_leaves(params)]
                with torch.enable_grad():
                    loss, _ = plain_model.loss(tree_unflatten(params, leaves),
                                               {"tokens": toks},
                                               remat=cfg.remat)
                    grads = torch.autograd.grad(loss, leaves)
                new, _ = opt.update(params, ost,
                                    tree_unflatten(params, list(grads)))
                return loss.detach(), new
        elif shape.kind == "prefill":
            args = (params, {"tokens": toks})

            def plain():
                with torch.no_grad():
                    return plain_model.forward(params, toks, remat=cfg.remat,
                                               last_only=True)[0][:, -1]
        else:
            caches = model.init_cache(B, S, torch.bfloat16, device=dev)
            for leaf in tree_leaves(caches):
                leaf.normal_(generator=torch.Generator(dev).manual_seed(91))
            index = torch.tensor(S - 1, dtype=torch.int32, device=dev)
            tok = toks[:, :1]
            args = (params, tok, caches, index)
            k0 = caches["scan"]["b0_attn"]["k"]
            row0 = {n: c[:, :, S - 1].clone() for n, c in
                    caches["scan"]["b0_attn"].items()}

            def plain():
                return plain_model.decode_step(params, tok, caches, index)[0]
        # the sharded step: once for its outputs (its warm-up), once under
        # the counter (DTensor's layout caches warm), then timed; K5
        # counted in the first run, the peak over the inputs' own bytes
        # (the dry-run's peak counts them too)
        in_bytes = sum({t.untyped_storage().data_ptr(): t.untyped_storage()
                        .nbytes() for t in pytree_leaves(args)
                        if isinstance(t, torch.Tensor)}.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        res = bundle.run(mesh, *args)
        torch.cuda.synchronize()
        k5 = counts()[4]
        peak = torch.cuda.max_memory_allocated() - base + in_bytes
        dargs = bundle.shard(mesh, *args)
        with CostCounter(dev) as c:
            c.track(dargs)
            bundle.fn(*dargs)
        torch.cuda.synchronize()
        del dargs
        sharded_ms, sharded_reps = timed(lambda: bundle.run(mesh, *args))
        # the unsharded step on the same inputs
        if shape.kind == "decode":
            for n, r in row0.items():        # the row the step wrote back
                caches["scan"]["b0_attn"][n][:, :, S - 1] = r
        want = plain()          # its warm-up too
        torch.cuda.synchronize()
        plain_ms, plain_reps = timed(plain)
        # hold the sharded outputs against the unsharded ones
        if shape.kind == "train":
            new_p, _, met = res
            got = [met["loss"].to_local()] + tree_leaves(local(new_p))
            ref = [want[0]] + tree_leaves(want[1])
        elif shape.kind == "prefill":
            got, ref = [res.to_local()], [want]
        else:
            got, ref = [res[0].to_local()], [want]
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max(errs)
        check(err <= SHARDED_RTOL, f"sharded {shape_id}: {err:.3g} of the "
              f"largest from the unsharded step (tol {SHARDED_RTOL})")
        # the counts against the 1x1 dry-run
        if fake is None:
            fake = wait_child(procs[1], logs[1], counts_path)
        d = fake[shape_id]
        check(c.flops == d["flops"] and c.bytes_accessed ==
              d["bytes_accessed"] and c.bytes_fused == d["bytes_fused"],
              f"sharded {shape_id}: counted {c.flops} FLOPs, "
              f"{c.bytes_accessed}/{c.bytes_fused} bytes on the card; the "
              f"1x1 dry-run {d['flops']}, {d['bytes_accessed']}/"
              f"{d['bytes_fused']}")
        if shape.kind == "prefill":
            check(k5 == SHARDED_K5, f"sharded prefill launched K5 {k5} "
                  f"times; expected {SHARDED_K5}")
        compute_s = c.flops / roofline.PEAK_FLOPS
        memory_s = c.bytes_fused / roofline.HBM_BW
        floor_s = roofline.hbm_floor_bytes(cfg, shape, 1) / roofline.HBM_BW
        mflops = roofline.model_flops(cfg, shape)
        mfu = mflops / (sharded_ms / 1e3) / roofline.PEAK_FLOPS
        check(min(sharded_reps + plain_reps) / 1e3 >= max(compute_s,
                                                           floor_s),
              f"sharded {shape_id}: a step time under its bound "
              f"max({compute_s:.4g}, {floor_s:.4g}) s")
        row = dict(shape=[B, S], overrides=over, ms=sharded_ms,
                   ms_reps=sharded_reps, plain_ms=plain_ms,
                   plain_ms_reps=plain_reps, host_overhead_ms=sharded_ms
                   - plain_ms, max_rel_err=err, errs=errs, bitwise=bitwise,
                   flops=c.flops, bytes_accessed=c.bytes_accessed,
                   bytes_fused=c.bytes_fused, coll=dict(c.coll_breakdown),
                   ops=c.ops, dryrun=d, compute_s=compute_s,
                   memory_s=memory_s, memory_floor_s=floor_s,
                   model_flops=mflops, mfu=mfu, peak_bytes=peak,
                   dryrun_peak_bytes=d["peak_bytes"], k5_launches=k5,
                   seconds=time.perf_counter() - t_step)
        steps_out[shape_id] = row
        print(f"sharded {shape_id} (1x1 nccl mesh, B={B}, S={S}"
              + (f", {over}" if over else "") + f") on {card}: median "
              f"{sharded_ms:.2f} ms ("
              + "/".join(f"{t:.2f}" for t in sharded_reps)
              + f") against the unsharded model's {plain_ms:.2f} ms ("
              + "/".join(f"{t:.2f}" for t in plain_reps)
              + f"), {sharded_ms - plain_ms:+.2f} ms of DTensor host time; "
              + ("outputs bitwise equal" if bitwise
                 else f"outputs {err:.3g} of the largest")
              + f" to the unsharded step's; counted {c.flops:.6e} FLOPs, "
              f"{c.bytes_accessed:.6e} bytes ({c.bytes_fused:.6e} fused) "
              f"over {c.ops} ops = the 1x1 dry-run's {d['flops']:.6e}, "
              f"{d['bytes_accessed']:.6e} ({d['bytes_fused']:.6e}); "
              f"compute {compute_s * 1e3:.3f} ms, memory {memory_s * 1e3:.3f}"
              f" ms, floor {floor_s * 1e3:.3f} ms; MFU {100 * mfu:.2f}% "
              f"(6/2·N·D {mflops:.4g} FLOP); peak {peak / 2**30:.3f} GiB "
              f"with the inputs against the dry-run's "
              f"{d['peak_bytes'] / 2**30:.3f} GiB; K5 {k5} launches")
        del res, want, got, ref, bundle, args, plain
        if shape.kind == "train":
            del opt, ost
        if shape.kind == "decode":
            del caches, k0, row0
        gc.collect()
        torch.cuda.empty_cache()
    out["steps"] = steps_out
    mesh_ok = mesh.size() == 1
    torch.distributed.destroy_process_group()
    check(mesh_ok, "the host mesh is not one chip")

    # ---- (a) the dry-run children -----------------------------------------
    t0 = time.perf_counter()
    for p in procs:
        try:
            p.wait(timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter() - t0),
                               1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise RuntimeError("chip_smoke: the dry-run children ran past "
                               f"{DRYRUN_TIMEOUT_S} s")
    wait_s = time.perf_counter() - t0
    log = logs[0].read_text()
    rcs = [line for line in log.splitlines() if line.startswith("rc=")]
    print(f"dry-run children: waited {wait_s:.2f} s in phase 19; "
          + "; ".join(rcs))
    for line in log.splitlines():
        if line.startswith(("[", "  cost", "  memory", "  collectives")):
            print("  " + line)
    check(procs[0].returncode == 0 and len(rcs) == 4
          and all(r.split()[0] == "rc=0" for r in rcs),
          f"a dry-run cell failed: {rcs}; the log's tail: {log[-3000:]}")
    rows = [json.loads(line) for line in rows_path.read_text().splitlines()]
    check(len(rows) == 8 and not any("error" in r for r in rows),
          f"expected 8 dry-run rows without an error, got {len(rows)}")
    want = {(SHARDED_ARCH, s, "single") for s in
            ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    want |= {(SHARDED_ARCH, "train_4k", "multi"),
             ("llama4-scout-17b-a16e", "train_4k", "single")}
    check(want <= {(r["arch"], r["shape"], r["mesh"]) for r in rows},
          "a dry-run cell is missing from the rows")
    buf = io.StringIO()
    with redirect_stdout(buf):
        roofline_table.main(["--glob", str(rows_path), "--all"])
    table = buf.getvalue()
    print("roofline_table over the dry-run rows (per chip of a 16x16 or "
          "2x16x16 mesh; H100 SXM peaks at 700 W):")
    print(table, end="")
    check(len(table.splitlines()) == 1 + len(roofline_table.load(
        [rows_path])), "roofline_table did not render every row")
    out["dryrun"] = {"rows": rows, "wait_s": wait_s}

    # ---- K5 alone at the prefill's shape ----------------------------------
    H, H_kv, D, S = 16, 8, 128, 32768
    q, k, v = (torch.randn((1, S, n, D), generator=gen(95 + i))
               .to(dev, torch.bfloat16).transpose(1, 2)
               for i, n in enumerate((H, H_kv, H_kv)))
    reset_counts()
    got = flash_attention(q, k, v, causal=True)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                         enable_gqa=True)
    torch.cuda.synchronize()
    check(counts()[4] == 1, "K5 did not launch at (1,16/8,32768,128)")
    k5_err = (got.float() - lib.float()).abs().max().item()
    check(k5_err <= ATTN_TOL["bfloat16"], f"K5 at (1,16/8,32768,128) "
          f"differs from the library by {k5_err}")
    # ... and against its plain f32 version on the first and the last 512
    # query rows, each row against every key it sees: a (1,16,512,32768)
    # f32 score block, 1 GiB, where the whole plain version takes 64 GiB
    rep = H // H_kv
    kf, vf = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))

    def rows_ref(lo, hi, keys=S):
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, lo:hi].float(),
                         kf[:, :, :keys]) * D ** -0.5
        s = s.masked_fill(torch.arange(keys, device=dev)[None, :]
                          > torch.arange(lo, hi, device=dev)[:, None],
                          float("-inf"))
        return torch.softmax(s, dim=-1) @ vf[:, :, :keys]

    def over_limit(rows, ref):
        """The largest |rows - ref| over its limit (1 is at the limit)."""
        lim = (K5_ROWS_ATOL * ref.pow(2).mean().sqrt()
               + K5_ROWS_RTOL * ref.abs())
        return ((rows - ref).abs() / lim).max().item()

    slices = {"first": (0, 512), "last": (S - 512, S)}
    row_err = {}
    for name, (lo, hi) in slices.items():
        ref = rows_ref(lo, hi)
        mine = got[:, :, lo:hi].float()
        row_err[name] = dict(max_abs_err=(mine - ref).abs().max().item(),
                             rms=ref.pow(2).mean().sqrt().item(),
                             of_limit=over_limit(mine, ref))
        check(row_err[name]["of_limit"] <= 1, f"K5's {name} 512 rows at "
              f"(1,16/8,32768,128) differ from the plain f32 rows: "
              f"{row_err[name]}")
    # the gate sees a kernel that drops the last 128-key tile
    lo, hi = slices["last"]
    dropped = over_limit(rows_ref(lo, hi, S - 128), ref)
    check(dropped > 1, f"the rows gate would not see a dropped KV tile "
          f"({dropped:.3g} of its limit)")
    print(f"K5 against its plain f32 version on rows of "
          f"(1,16/8,32768,128), limit {K5_ROWS_ATOL} x RMS + "
          f"{K5_ROWS_RTOL} x |plain| an element: " + ", ".join(
              f"{n} 512 rows max_abs_err {e['max_abs_err']:.3g} (RMS "
              f"{e['rms']:.3g}), {e['of_limit']:.3g} of the limit"
              for n, e in row_err.items())
          + f"; the last rows without their last 128 keys: {dropped:.3g} "
          f"of it")
    del kf, vf, ref, mine
    reps = [cuda_ms(lambda: flash_attention(q, k, v, causal=True), iters=3,
                    warmup=1) for _ in range(3)]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=3, warmup=1)
    flops = 4 * D * attention_pairs(S, None) * H
    b_ms, b_by = bound(nbytes(q, k, v, got), flops, PEAK_BF16_FLOP_S)
    k5_ms = median(reps)
    print(f"K5 flash_attention at the sharded prefill's (1,16/8,32768,128) "
          f"bf16 on {card}: {k5_ms:.4f} ms (median of "
          + "/".join(f"{t:.4f}" for t in reps)
          + f"), library {lib_ms:.4f} ms (scaled_dot_product_attention), "
          f"max_abs_err {k5_err:.3g} against it; plain not timed (its "
          f"(1,16,32768,32768) f32 scores take 64 GiB); bound {b_ms:.4f} ms "
          f"({b_by}, {flops / 1e12:.4g} TFLOP), "
          f"{flops / k5_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * b_ms / k5_ms:.2f}% of the bound")
    out["k5_32k"] = dict(ms=k5_ms, ms_reps=reps, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=k5_err,
                         plain_rows=row_err, dropped_tile_of_limit=dropped,
                         shape=[1, H, S, D], kv_heads=H_kv)
    del q, k, v, got, lib, params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"sharded phase: {out['seconds']:.2f} s (target 45 s)")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the port's static analysis
# ---------------------------------------------------------------------------
# ``python -m repro_torch.analysis --strict`` runs in a child started before
# phase 1 (it needs no device and about 10 s of one core) and is collected
# here; the phase holds the shared-memory audit's constant against the card.

def start_lint():
    """Start phase 20's child from the checkout's root, with no device
    visible to it.  Returns (the Popen, the thread that waits for it, and
    the dict where that thread puts its output and seconds)."""
    import threading
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    done = {}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def wait():
        done["out"] = proc.communicate()[0]
        done["seconds"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return proc, waiter, done


def lint_phase(card, lint) -> dict:
    """Phase 20: the strict lint's exit code, counts and seconds, and
    ``passplan.SMEM_LIMIT`` (the budget ``kernel-smem`` audits and the
    tile planner packs to) against the card's opt-in shared memory of one
    block."""
    import re
    import torch
    from repro_torch.analysis import load_context, rule_names
    from repro_torch.analysis.__main__ import DEFAULT_PATHS
    from repro_torch.core.passplan import SMEM_LIMIT

    torch.cuda.synchronize()  # the earlier phases' work is not this phase's
    t_phase = time.perf_counter()
    proc, waiter, done = lint
    waiter.join(timeout=300)
    check(not waiter.is_alive(), "python -m repro_torch.analysis --strict "
          "did not end within 300 s of phase 20's start")
    text = done["out"]
    print(text.rstrip())
    m = re.search(r"strict: (\d+) new, (\d+) baselined, (\d+) suppressed, "
                  r"(\d+) stale", text)
    check(proc.returncode == 0 and m is not None,
          f"python -m repro_torch.analysis --strict exited "
          f"{proc.returncode}:\n{text[-4000:]}")
    new, baselined, suppressed, stale = map(int, m.groups())
    # the scan's files and waivers, as the child's CLI scanned them
    ctx = load_context(list(DEFAULT_PATHS), ROOT, runtime=False)
    waivers = sum(len(f.suppressions()) for f in ctx.files)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    print(f"analysis [{card}]: python -m repro_torch.analysis --strict exit "
          f"{proc.returncode} in {done['seconds']:.2f} s (started before "
          f"phase 1): {len(rule_names())} rules over {len(ctx.files)} "
          f"files, {new + baselined} findings ({new} new, {baselined} "
          f"baselined), {suppressed} suppressed by {waivers} waivers")
    print(f"analysis [{card}]: passplan.SMEM_LIMIT {SMEM_LIMIT} B, the "
          f"card's shared_memory_per_block_optin {optin} B")
    check(SMEM_LIMIT == optin, f"passplan.SMEM_LIMIT {SMEM_LIMIT} B is not "
          f"the card's shared_memory_per_block_optin {optin} B")
    return dict(rc=proc.returncode, rules=len(rule_names()),
                files=len(ctx.files), findings=new + baselined, new=new,
                baselined=baselined, suppressed=suppressed, stale=stale,
                waivers=waivers, seconds=done["seconds"],
                smem_limit=SMEM_LIMIT, smem_per_block_optin=optin,
                card=card, phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Phase 21: the dense decoders at full width and long_500k's decode
# ---------------------------------------------------------------------------
# Gates, each as an earlier phase sets it: phase 17's, through the same
# helper (decoder_full_width): a split decision's K5 launches (one a
# layer, all on the tensor cores, no input copied), the float32 codec's
# split bit for bit its monolith and the uint8 split's logits and payload
# as phase 9 gates them; init's peak within FAM_INIT_PEAK of the
# parameters' bytes; decode against the forward in f32 over an f32 cache
# within LM_DECODE_TOL with top-1 agreement >= FAM_TOP1 (the dense
# configs' first DENSE_F32_PROMPT prompt tokens: a decode step costs
# 2.2-4.1 ms of host time a layer whatever its width, so the rest of
# their prompt in f32 would cost the script another 17-26 s), and in bf16
# within LM_BF16_FLOOR times the bf16 forward's own distance from the f32
# forward (the scout's forward at a capacity that drops nothing, as phase
# 17's MoE); the scout's router over all 16 experts and its shared expert in
# its output (the sum rounds to bf16 three times: within 2^-6 of the
# largest term).  long_500k: 28 K5 launches in the 8,192-token prefill,
# all on the tensor cores; the window-gather decode against the
# whole-cache decode within LM_BF16_FLOOR times the bf16 prefill's
# distance from the f32 prefill at the prompt's last 32 positions (the
# routes differ only in the attention's order of sums, but a bf16
# rounding anywhere grows through 28 layers: two bf16 computations part
# by about as much as bf16 and f32 do, as phase 16 shows for its two
# forwards); the row just outside the window changed, the deep step's
# logits bitwise unchanged on both routes, and the window's first row
# changed, changed.
DENSE_CONFIGS = (("llama3-8b", 32), ("qwen2.5-14b", 48), ("minitron-8b", 32))
SCOUT = "llama4-scout-17b-a16e"
SCOUT_LAYERS = 2          # of its 48, at full width: 215.5 GB fit no card
DENSE_F32_PROMPT = 64     # prompt tokens the dense configs decode in f32
LONG_PROMPT = 8192        # long_500k's prefill, two 4,096 windows deep
LONG_TAIL = 32            # prompt positions held bf16 against f32
SHARED_TOL = 2.0 ** -6


def dense_phase(dev, gen, reset_counts, counts, card):
    """Phase 21: (a) llama3-8b, qwen2.5-14b and minitron-8b uncut at full
    width, each drawn on the card from seed 0 and freed before the next:
    :func:`decoder_full_width`'s split decision and decode, as phase 17
    runs them; (b) the same for llama4-scout-17b-a16e at full width with 2
    of its 48 layers, its split through ``split_params``, with its router
    and shared expert checked;
    (c) Qwen3-0.6B at long_500k: an 8,192-token prefill through
    ``forward(..., long_ctx=True)`` (K5 windowed at 4,096), its K/V rows
    copied into a 524,288-deep bf16 cache, 32 greedy tokens with
    ``windowed_decode_gather`` off and the same tokens with it on, then
    one step at index 524,287 of a cache drawn from a seeded generator on
    each route.  Returns the ``{"dense": ...}`` dict."""
    import gc
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import blocks
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn.layers import swiglu
    from repro_torch.nn.module import cast_tree, param_bytes, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()  # the earlier phases' work is not this phase's
    t_phase = time.perf_counter()
    say = lambda msg: print(f"dense [{card}]: {msg}")  # noqa: E731
    out = {"card": card, "held_before": torch.cuda.memory_allocated()}

    def max_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    # ---- (a) the three dense configs, uncut -------------------------------
    configs = {}
    for arch, k5_want in DENSE_CONFIGS:
        cfg = get_config(arch)
        check(cfg.n_layers == k5_want and cfg.dtype == "bfloat16"
              and cfg.moe is None, f"{arch}: not its published config")
        configs[arch] = decoder_full_width(
            arch, cfg, DecoderModel(cfg), k5_want, dev, gen, reset_counts,
            counts, arch=arch, say=say, f32_prompt=DENSE_F32_PROMPT)
        gc.collect()
        torch.cuda.empty_cache()
    out["configs"] = configs

    # ---- (b) llama4-scout at full width, 2 of its 48 layers ---------------
    full_cfg = get_config(SCOUT)
    cfg = dataclasses.replace(full_cfg, n_layers=SCOUT_LAYERS,
                              n_pattern=SCOUT_LAYERS)
    check(full_cfg.d_model == 5120 and full_cfg.moe.n_experts == 16
          and full_cfg.moe.top_k == 1 and full_cfg.n_heads == 40,
          f"{SCOUT}: not its published config")
    model = DecoderModel(cfg)
    name = f"{SCOUT} ({SCOUT_LAYERS} of {full_cfg.n_layers} layers)"

    def scout_moe(params, prompt):
        """The scout's router reaches all 16 experts over the decision's
        tokens, and its shared expert is in every output."""
        with torch.inference_mode():
            _, records = routed(lambda: model.forward(params, prompt))
        experts = sorted({int(e) for r in records
                          for e in r["expert_idx"].flatten().tolist()})
        probs_ok = all(r["probs"].shape[-1] == cfg.moe.n_experts
                       and bool((r["probs"] > 0).all()) for r in records)
        mcfg = blocks.moe_config(cfg)
        p0 = tree_map(lambda t: t[0], params["scan"]["b0_attn"]["moe"])
        h = torch.randn((1, DEC_PROMPT, cfg.d_model), generator=gen(27)) \
            .to(dev, torch.bfloat16)
        with torch.inference_mode():
            y, _ = blocks.moe_apply(p0, mcfg, h)
            y_routed, _ = blocks.moe_apply(
                {k: v for k, v in p0.items() if k != "shared"}, mcfg, h)
            shared = swiglu(p0["shared"], h)
        scale = max(y.abs().max().item(), y_routed.abs().max().item(),
                    shared.abs().max().item())
        shared_err = max_err(y.float() - y_routed.float(), shared)
        say(f"{name} MoE: {len(records)} layers routed the decision over "
            f"{mcfg.n_experts} experts (probabilities all non-zero "
            f"{probs_ok}), top-{mcfg.top_k} picked {len(experts)} distinct "
            f"experts {experts}; the layer's output less its routed part is "
            f"the shared expert's within {shared_err:.4g} (limit "
            f"{SHARED_TOL} x {scale:.4g}), the shared expert's largest "
            f"{shared.abs().max().item():.4g}")
        check(len(records) == cfg.n_layers and probs_ok
              and mcfg.n_experts == 16 and mcfg.n_shared_experts == 1,
              f"{name}: the router's probabilities over the experts: "
              f"{len(records)} layers, all non-zero {probs_ok}")
        check(shared_err <= SHARED_TOL * scale
              and shared.abs().max().item() > SHARED_TOL * scale,
              f"{name}: the shared expert is not in the layer's output "
              f"({shared_err} against {SHARED_TOL} x {scale})")
        return dict(n_experts=mcfg.n_experts, n_shared=mcfg.n_shared_experts,
                    experts_picked=experts, probs_nonzero=probs_ok,
                    shared_err=shared_err, shared_scale=scale)

    row = decoder_full_width(name, cfg, model, SCOUT_LAYERS, dev, gen,
                             reset_counts, counts, say=say, extra=scout_moe)
    row["moe"] = row.pop("extra")
    out["scout"] = dict(row, n_layers=SCOUT_LAYERS,
                        published_layers=full_cfg.n_layers)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) Qwen3-0.6B at long_500k --------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    depth, W = SHAPES["long_500k"].seq_len, cfg.long_context_window
    check(depth == 524288 and W == 4096 and not cfg.windowed_decode_gather,
          f"long_500k: depth {depth}, window {W}")
    model = DecoderModel(cfg)
    model_g = DecoderModel(dataclasses.replace(cfg,
                                               windowed_decode_gather=True))
    params = serve_cli.init_params(model, dev)
    w_bytes = param_bytes(params)
    prompt = torch.randint(3, cfg.vocab, (1, LONG_PROMPT),
                           generator=gen(23)).to(dev, torch.int32)
    # the prefill, each attention block's rotated K and its V recorded as
    # the forward projects them: the rows a decode step writes
    rows, project = [], attn_mod._project_qkv

    def recording(*args, **kwargs):
        q, k, v = project(*args, **kwargs)
        rows.append((k, v))
        return q, k, v
    attn_mod._project_qkv = recording
    try:
        reset_counts()
        with torch.inference_mode():
            full = model.forward(params, prompt, long_ctx=True)[0]
        torch.cuda.synchronize()
        pre_counts = counts()
        pre_tc = flash_attention.tc_launches
        pre_copies = flash_attention.copies
    finally:
        attn_mod._project_qkv = project
    check(pre_counts == (0, 0, 0, 0, cfg.n_layers) and pre_tc == cfg.n_layers
          and pre_copies == 0 and len(rows) == cfg.n_layers,
          f"long_500k prefill: K1..K5 {pre_counts}, {pre_tc} on the tensor "
          f"cores, {pre_copies} copies, {len(rows)} K/V rows recorded; "
          f"expected {cfg.n_layers} windowed launches")
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: model.forward(
            params, prompt, long_ctx=True, last_only=True), iters=2,
            warmup=1)
        params32 = cast_tree(params, torch.float32)
        tail32 = DecoderModel(dataclasses.replace(cfg, dtype="float32")) \
            .forward(params32, prompt, long_ctx=True)[0][:, -LONG_TAIL:]
    floor = max_err(full[:, -LONG_TAIL:], tail32)
    first = full[:, -1:].argmax(-1).to(torch.int32)
    del params32, tail32, full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(1, depth, torch.bfloat16, device=dev)
    k_all, v_all = cache["scan"]["b0_attn"]["k"], cache["scan"]["b0_attn"]["v"]
    cache_bytes = nbytes(k_all, v_all)
    check(tuple(k_all.shape) == (cfg.n_layers, 1, depth, cfg.n_kv_heads,
                                 cfg.head_dim) and k_all.numel() > 2 ** 31,
          f"long_500k cache {tuple(k_all.shape)}")
    for layer, (k, v) in enumerate(rows):
        k_all[layer, :, :LONG_PROMPT].copy_(k)
        v_all[layer, :, :LONG_PROMPT].copy_(v)
    del rows, k, v
    say(f"long_500k: qwen3-0.6b ({w_bytes} B of weights), prefill of "
        f"{LONG_PROMPT} tokens with every attention block windowed at {W}: "
        f"K1..K5 {pre_counts} ({pre_tc} on the tensor cores, {pre_copies} "
        f"copies), {prefill_ms:.4f} ms by CUDA events (last position's "
        f"logits); the bf16 prefill's last {LONG_TAIL} positions "
        f"{floor:.4g} from the f32 prefill's; cache "
        f"{tuple(k_all.shape)} x 2 bf16, {cache_bytes} B, its K/V rows "
        f"0..{LONG_PROMPT - 1} the prefill's")

    def greedy(m, forced=None):
        """32 tokens from the prompt's next one; with ``forced``, those
        tokens fed in turn (the other route's greedy ones)."""
        i = torch.full((), LONG_PROMPT, dtype=torch.int64, device=dev)
        tok, toks, lgs = first, [], []
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        for t in range(DEC_NEW):
            if forced is not None:
                tok = forced[:, t:t + 1]
            lg, _ = m.decode_step(params, tok, cache, i, long_ctx=True)
            i += 1
            toks.append(tok)
            lgs.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        ev1.record()
        ev1.synchronize()
        return torch.cat(toks, 1), torch.cat(lgs, 1), \
            ev0.elapsed_time(ev1) / DEC_NEW

    reset_counts()
    toks_off, lg_off, ms_off = greedy(model)
    _, lg_on, ms_on = greedy(model_g, toks_off)
    torch.cuda.synchronize()
    dec_counts = counts()
    route_err = max_err(lg_off, lg_on)
    same_next = (lg_on[:, :-1].argmax(-1) == toks_off[:, 1:]).float().mean() \
        .item()
    say(f"long_500k decode B=1 at positions {LONG_PROMPT}..."
        f"{LONG_PROMPT + DEC_NEW - 1} over the {depth}-deep cache: "
        f"{DEC_NEW} greedy tokens {toks_off[0].tolist()} with the window "
        f"scored over the "
        f"whole cache ({ms_off:.4f} ms a token by CUDA events), the same "
        f"tokens with the window gathered ({ms_on:.4f} ms a token): logits "
        f"max_abs_err {route_err:.4g} (limit {LM_BF16_FLOOR} x {floor:.4g}), "
        f"the gathered route's next token the same {same_next:.4f} of the "
        f"time; K1..K5 launches while decoding {dec_counts}")
    check(dec_counts == (0,) * 5, f"long_500k decode launched K1..K5 "
          f"{dec_counts}")
    check(torch.isfinite(lg_off.float()).all() and route_err
          <= LM_BF16_FLOOR * floor, f"long_500k: the gathered decode's logits "
          f"are {route_err} from the whole-cache decode's (limit "
          f"{LM_BF16_FLOOR} x {floor})")

    # one step at the deepest index over a cache drawn from a seeded
    # generator, on each route
    draw = torch.Generator(device=dev).manual_seed(24)
    for t in (k_all, v_all):
        t.normal_(generator=draw)
    idx = depth - 1
    i_deep = torch.full((), idx, dtype=torch.int64, device=dev)
    tok5 = torch.full((1, 1), 5, dtype=torch.int32, device=dev)
    window_bytes = cache_bytes // depth * W
    routes = {}
    for route, m, b_bytes in (("gather off", model, cache_bytes),
                              ("gather on", model_g, 2 * window_bytes)):
        torch.cuda.reset_peak_memory_stats()

        def step(m=m):
            return m.decode_step(params, tok5, cache, i_deep,
                                 long_ctx=True)[0]
        lg = step().clone()
        ms = cuda_ms(step, iters=3, warmup=1)
        routes[route] = dict(logits=lg, ms=ms,
                             bound_ms=(w_bytes + b_bytes) / PEAK_BYTES_S * 1e3,
                             peak_bytes=torch.cuda.max_memory_allocated(),
                             step=step)
    deep_err = max_err(routes["gather off"]["logits"],
                       routes["gather on"]["logits"])
    # a row just outside the window, and then one inside it, changed in
    # every layer
    outside, inside = idx - W, idx - W + 1
    for t in (k_all, v_all):
        t[:, :, outside] = 8.0
    unchanged = {r: torch.equal(v["step"](), v["logits"])
                 for r, v in routes.items()}
    for t in (k_all, v_all):
        t[:, :, inside] = 8.0
    moved = {r: not torch.equal(v["step"](), v["logits"])
             for r, v in routes.items()}
    torch.cuda.synchronize()
    for r, v in routes.items():
        say(f"long_500k one step at index {idx} over a cache drawn from a "
            f"seeded generator, {r}: {v['ms']:.4f} ms by CUDA events (mean "
            f"of 3), bytes bound {v['bound_ms']:.4f} ms (weights + "
            + ("the whole cache once" if r == "gather off"
               else f"the {W}-row window read and copied") + "), "
            f"max_memory_allocated {v['peak_bytes']} B; row {outside} "
            f"changed: logits bitwise unchanged {unchanged[r]}; row {inside} "
            f"changed: logits changed {moved[r]}")
    say(f"long_500k deep step: the two routes' logits {deep_err:.4g} apart "
        f"(limit {LM_BF16_FLOOR} x {floor:.4g})")
    check(deep_err <= LM_BF16_FLOOR * floor, f"long_500k deep step: the "
          f"routes' logits {deep_err} apart")
    check(all(unchanged.values()) and all(moved.values()),
          f"long_500k deep step: a row outside the window changed the logits "
          f"({unchanged}) or one inside it did not ({moved})")
    out["long_500k"] = dict(
        depth=depth, window=W, prompt=LONG_PROMPT, weight_bytes=w_bytes,
        cache_bytes=cache_bytes, prefill_launches=list(pre_counts),
        prefill_tc_launches=pre_tc, prefill_copies=pre_copies,
        prefill_ms=prefill_ms, bf16_vs_f32_tail_err=floor,
        floor_limit=LM_BF16_FLOOR, greedy_tokens=toks_off[0].tolist(),
        decode_launches=list(dec_counts), ms_per_token_gather_off=ms_off,
        ms_per_token_gather_on=ms_on, routes_max_abs_err=route_err,
        routes_same_next_token=same_next, deep_routes_max_abs_err=deep_err,
        deep={r: {k: v[k] for k in ("ms", "bound_ms", "peak_bytes")}
              for r, v in routes.items()},
        outside_row_unchanged=unchanged, inside_row_moved=moved,
        seconds=time.perf_counter() - t0)
    del cache, k_all, v_all, routes, params, lg_off, lg_on
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say(f"phase {out['seconds']:.2f} s (target 90 s)")
    return out

# K7 against its plain version (per-expert torch.matmul in f32, the hidden
# rounded to bf16 at the same place): both sum 4,096- and 768-term products
# in f32 in another order, so now and then a hidden value near a bf16
# rounding boundary rounds the other way, by one bf16 spacing of itself.
# On a large hidden value that moves its output row's elements by up to a
# few thousandths (0.0052 of an output RMS of 0.345 at the served shape,
# the first card runs), and ||K7 - plain|| / ||plain|| reads 2.2e-4 to
# 2.3e-4 (torch._grouped_mm, which rounds gate and up to bf16 before the
# SiLU, reads 3.9e-3).  So the whole output is held to K7_REL, 4x over
# those readings, and each element to K7_MAX times the output's RMS.  A
# row computed by the wrong expert moves the output by its own size (1.41
# read), a dropped 64-deep stage of the gate|up GEMM by about an eighth
K7_REL = 2.0 ** -10
K7_MAX = 2.0 ** -3
# K5 in bf16 with granite-4.0-h's 1/128 scale against the plain f32
# version at the same scale, as a block: ||K5 - plain|| <= K5_WINDOW_RTOL
# * ||plain||.  At 1/128 the softmax is flat: early rows average a few
# values of size up to 4, late rows thousands, so neither ATTN_TOL's
# absolute 0.01 (read 0.0091) nor the K5_ROWS element rule (read 1.56 of
# it, on late rows near 0) is a rounding bound there; rounding P and the
# output to bf16 moves the block by about 2^-9.  The default head_dim **
# -0.5 scale on the same inputs gives softmax weights 11x sharper and
# reads far outside it (the phase checks that too)

# K8 (bf16 views of the conv's output) against the plain f32 scan on the
# same values, element by element: |K8 - plain| <= K8_TOL * max|plain| +
# 2^-8 |plain|.  K8 sums in another order, and its cumulative and segment
# sums in float64 (tests/test_torch_ssd_scan.py holds f32 inputs at
# K8_TOL alone); y is rounded once to bf16, which moves it by up to 2^-9
# of itself.  The final state, f32, is held at K8_TOL of its largest.
K8_TOL = 1e-5

# K9 (bf16 output) against the plain float32 sum S of the same rows, element
# by element: |K9 - S| <= 2^-8 |S| + K9_REORDER * max|S|.  K9 rounds S once
# to bf16, half a bf16 step at most (2^-8 of |S|), and adds its K + 1 terms
# in its own fixed order, which moves S by float32 reordering alone (a few
# 1e-7 of the largest sum at K = 10).  Every token reading a neighbour's
# rows moves its sum by about its own size.
K9_REORDER = 1e-6


GRANITE = "granite-4.0-h-small"
GRANITE_LAYERS = 20       # of its 40: the benchmark cell's first two periods
GRANITE_TICK = (4, 2048)  # the cell's prompts x tokens a decision


def granite_served(dev):
    """One decision of ``granite4h.pf4x2048`` through the program's own
    path, as ``bench/systems/hybrid_lm.py`` serves it: granite-4.0-h at
    full width cut to ``GRANITE_LAYERS`` layers, drawn on the card from
    seed 0, split after the first period (``split_params``), the edge's
    ``edge_forward`` -> the uint8 codec -> ``server_forward(...,
    last_only=True)``.  One decision warms it; K7's, K5's, K8's, K9's and
    the dropless route's counts are set to 0 just before the second.  Every
    tensor it makes is freed when it returns.  Returns the counts."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.split import make_split_policy
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_combine import moe_combine
    from repro_torch.kernels.moe_grouped import moe_grouped
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn import moe

    full = get_config(GRANITE)
    check(full.n_layers == 40 and full.d_model == 4096
          and full.moe.n_experts == 72 and full.moe.top_k == 10
          and full.moe.dropless and full.ssm_ffn,
          f"{GRANITE}: not its published config")
    period = len(full.pattern)
    cfg = dataclasses.replace(full, n_layers=GRANITE_LAYERS,
                              n_pattern=GRANITE_LAYERS // period,
                              remainder=())
    model = DecoderModel(cfg)
    params = serve_cli.init_params(model, dev)
    edge_p, server_p = model.split_params(params, 1)
    del params
    split = make_split_policy(
        model.edge_forward,
        lambda prm, h: model.server_forward(prm, h, last_only=True),
        codec="uint8")
    B, S = GRANITE_TICK
    tokens = torch.randint(0, cfg.vocab, (B, S), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(31))

    def decide():
        with torch.inference_mode(), moe.recorded_routes(routes):
            payload = split.edge_step_batch(edge_p, tokens)
            return payload, split.server_step_batch(server_p, payload)

    routes: list = []
    decide()
    torch.cuda.synchronize()
    routes.clear()
    moe_grouped.launches = flash_attention.launches = ssd_scan.launches = 0
    moe_combine.launches = 0
    moe.reset_counters()
    t0 = time.perf_counter()
    payload, logits = decide()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    k7, k5, k8, k9 = (moe_grouped.launches, flash_attention.launches,
                      ssd_scan.launches, moe_combine.launches)
    rows = moe.dropless_counters()
    n_attn = sum(k == "attn" for k in cfg.blocks())
    print(f"{GRANITE} ({GRANITE_LAYERS} of {full.n_layers} layers, "
          f"{cfg.param_count():,} parameters), one decision of {B} x {S} "
          f"tokens split after layer {period - 1}: {ms:.1f} ms; K7 "
          f"{k7} launches, K5 {k5}, K8 {k8}, K9 {k9}, {rows['routed_rows']} "
          f"routed rows (the most on one expert "
          f"{rows['max_expert_rows']}), payload "
          f"{tuple(payload['data'].shape)} {payload['data'].dtype}, logits "
          f"{tuple(logits.shape)}")
    check(k7 == k9 == cfg.n_layers == 20 and k5 == n_attn == 2
          and k8 == cfg.n_layers - n_attn == 18
          and len(routes) == cfg.n_layers
          and rows["routed_rows"] == cfg.n_layers * B * S * cfg.moe.top_k,
          f"{GRANITE}: a decision launched K7 {k7}, K5 {k5}, K8 {k8} and "
          f"K9 {k9} times over {len(routes)} routed layers, "
          f"{rows['routed_rows']} rows")
    check(payload["data"].dtype == torch.uint8
          and tuple(payload["data"].shape) == (B, S, cfg.d_model)
          and tuple(logits.shape) == (B, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{GRANITE}: payload {payload['data'].shape} "
          f"{payload['data'].dtype}, logits {logits.shape}")
    out = dict(layers=cfg.n_layers, published_layers=full.n_layers,
               params=cfg.param_count(), tokens=[B, S], ms=ms,
               k7_launches=k7, k5_launches=k5, k8_launches=k8,
               k9_launches=k9, **rows)
    del edge_p, server_p, payload, logits, routes, split, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def granite_k8(dev, g):
    """K8 (``kernels.ssd_scan``) at the cell's Mamba-2 shape: 4 prompts x
    2,048 steps, 128 heads of 64, N 128, one group, chunks of 256, x, B
    and C bf16 views of one (4, 2,048, 8,448) tensor as the conv leaves
    them, against the plain f32 ``ssd_chunked`` on the same values (a
    rolled dt must fail the limit), bit for bit between two runs, and
    timed beside its float32 bound and the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import ssd_chunked
    from repro_torch.kernels.ssd_scan import flops, min_bytes, ssd_scan
    from repro_torch.nn.ssm import SSMConfig
    b, S, H, P, G, N, Q = 4, 2048, 128, 64, 1, 128, 256
    cfg = SSMConfig(d_model=4096, chunk=Q)
    xbc = torch.randn((b, S, H * P + 2 * G * N), generator=g,
                      device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(b, S, H, P)
    B = xbc[..., H * P:H * P + G * N].reshape(b, S, G, N)
    C = xbc[..., H * P + G * N:].reshape(b, S, G, N)
    dt = F.softplus(torch.randn((b, S, H), generator=g, device=dev) - 1.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    D = torch.randn((H,), generator=g, device=dev)

    def k8(dt=dt):
        return ssd_scan(cfg, x, dt, A, B, C, D)

    def plain():
        return ssd_chunked(cfg, x.float(), dt, A, B.float(), C.float(), D)

    def excess(got, want, rounding):
        """The largest |got - want| over its limit, K8_TOL * max|want| +
        rounding * |want|."""
        want = want.float()
        limit = K8_TOL * want.abs().max() + rounding * want.abs()
        return ((got.float() - want).abs() / limit).max().item()

    with torch.inference_mode():
        ssd_scan.launches = 0
        y, h = k8()
        torch.cuda.synchronize()
        check(ssd_scan.launches == 1, "K8 did not launch")
        wy, wh = plain()
        y_x, h_x = excess(y, wy, 2.0 ** -8), excess(h, wh, 0.0)
        y2, h2 = k8()
        same = torch.equal(y, y2) and torch.equal(h, h2)
        wrong = excess(k8(dt.roll(1, -1))[0], wy, 2.0 ** -8)
        y_max, h_max = wy.abs().max().item(), wh.abs().max().item()
        del wy, wh, y2, h2
        ms = cuda_ms(k8, iters=20, warmup=3)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        dev_us = kernel_device_us(k8, "ssd_", calls=10)
    fl, nb = flops(b, S, H, G, P, N, Q), min_bytes(b, S, H, G, P, N)
    b_ms, b_by = bound(nb, fl)
    dev_ms = None if dev_us is None else dev_us[0] * dev_us[1] / 1e3
    print(f"K8 at ({b}, {S}, {H} x {P}, N {N}, G {G}) bf16 views, chunks of "
          f"{Q}: y within {y_x:.3g} of its limit (K8_TOL {K8_TOL:g} of "
          f"{y_max:.4g} + 2^-8 |y|), h_final {h_x:.3g} of its (K8_TOL of "
          f"{h_max:.4g}); bit for bit between runs: {same}; a rolled dt "
          f"reads {wrong:.3g} of the limit")
    check(y_x <= 1 and h_x <= 1, f"K8 off its plain version: {y_x}, {h_x}")
    check(same, "K8 is not bit for bit between two runs")
    check(wrong > 100, f"K8 with a rolled dt reads {wrong}, within 100x "
          f"its limit")
    print(f"K8: {ms:.4f} ms a call (events, 20 calls; device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms in "
          f"{None if dev_us is None else dev_us[1]} kernels), bound "
          f"{b_ms:.4f} ms ({b_by}: {fl / 1e9:.2f} GFLOP, {nb / 1e6:.1f} MB), "
          f"{100 * b_ms / ms:.1f}% of it; plain {plain_ms:.4f} ms; "
          f"{fl / ms / 1e9:.1f} TFLOP/s")
    return dict(shape=[b, S, H, P, G, N, Q], y_limit_share=y_x,
                h_limit_share=h_x, rolled_dt_limit_share=wrong,
                bitwise=same, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=fl,
                min_bytes=nb, phase_launches=ssd_scan.launches)


def granite_k9(dev, g):
    """K9 (``kernels.moe_combine``) at the cell's combine shape: 8,192
    tokens routed top-10 over 72 experts and sorted as the layer sorts
    them, D 4,096, float32 rows (1.34 GB) and a bf16 shared row, against
    the plain float32 sum (a ``pos`` rolled by one must fail the limit),
    bit for bit between two runs, and timed beside its memory bound, the
    plain version and the chain the layer ran before K9 (zeros,
    ``index_add_``, the shared row's add, the cast), a yardstick the port
    no longer calls."""
    import torch
    from repro_torch.kernels.moe_combine import flops, min_bytes, moe_combine
    from repro_torch.kernels.ref import moe_combine_ref
    T, K, D, E = 8192, 10, 4096, 72
    idx = torch.topk(torch.randn((T, E), generator=g, device=dev), K,
                     dim=-1).indices
    _, order = torch.sort(idx.reshape(-1), stable=True)
    token = order // K
    pos = torch.empty_like(order, dtype=torch.int32).scatter_(
        0, order, torch.arange(T * K, dtype=torch.int32, device=dev)
    ).view(T, K)
    out = torch.randn((T * K, D), generator=g, device=dev) * 0.3
    shared = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)

    def k9(pos=pos):
        return moe_combine(out, pos, shared, dtype=torch.bfloat16)

    def plain():
        return moe_combine_ref(out, pos, shared, dtype=torch.bfloat16)

    def chain():
        y = torch.zeros((T, D), dtype=torch.float32, device=dev)
        y.index_add_(0, token, out)
        y += shared.float()
        return y.to(torch.bfloat16)

    def excess(got, want):
        """The largest |got - want| over its limit, 2^-8 |want| +
        K9_REORDER * max|want|."""
        limit = 2.0 ** -8 * want.abs() + K9_REORDER * want.abs().max()
        return ((got.float() - want).abs() / limit).max().item()

    with torch.inference_mode():
        moe_combine.launches = 0
        y = k9()
        torch.cuda.synchronize()
        check(moe_combine.launches == 1, "K9 did not launch")
        want = moe_combine_ref(out, pos, shared, dtype=torch.float32)
        y_x, chain_x = excess(y, want), excess(chain(), want)
        same = torch.equal(y, k9())
        wrong = excess(k9(pos.reshape(-1).roll(1).view(T, K)), want)
        y_max = want.abs().max().item()
        del want
        ms = cuda_ms(k9, iters=20, warmup=3)
        plain_ms = cuda_ms(plain, iters=5, warmup=1)
        chain_ms = cuda_ms(chain, iters=10, warmup=2)
        dev_us = kernel_device_us(k9, "moe_combine_kernel", calls=10)
    fl, nb = flops(T, K, D), min_bytes(T, K, D)
    b_ms, b_by = bound(nb, fl)
    dev_ms = None if dev_us is None else dev_us[0] * dev_us[1] / 1e3
    print(f"K9 at {T} tokens x top-{K}, D {D}, f32 rows and a bf16 shared "
          f"row: within {y_x:.3g} of its limit (2^-8 |S| + {K9_REORDER:g} "
          f"of {y_max:.4g}); the replaced chain reads {chain_x:.3g}; bit "
          f"for bit between runs: {same}; pos rolled by one reads "
          f"{wrong:.3g} of the limit")
    check(y_x <= 1, f"K9 off its plain version: {y_x}")
    check(same, "K9 is not bit for bit between two runs")
    check(wrong > 100, f"K9 with pos rolled by one reads {wrong}, within "
          f"100x its limit")
    print(f"K9: {ms:.4f} ms a call (events, 20 calls; device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms in "
          f"{None if dev_us is None else dev_us[1]} kernels), bound "
          f"{b_ms:.4f} ms ({b_by}: {nb / 1e9:.4f} GB), "
          f"{100 * b_ms / ms:.1f}% of it, {nb / ms / 1e6:.1f} GB/s; plain "
          f"{plain_ms:.4f} ms; the replaced zeros + index_add_ + add + "
          f"cast chain {chain_ms:.4f} ms")
    return dict(shape=[T, K, D], limit_share=y_x, chain_limit_share=chain_x,
                rolled_pos_limit_share=wrong, bitwise=same, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, chain_ms=chain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=fl,
                min_bytes=nb, bound_share=b_ms / ms,
                phase_launches=moe_combine.launches)


def granite_phase(dev, card):
    """Phase 22: K7 (``kernels.moe_grouped``) at granite-4.0-h's expert
    shape, 72 experts, 8,192 tokens routed top-10 (about 1,138 rows an
    expert), D 4,096, F 768, against its plain version and
    ``torch._grouped_mm`` (the library row, a yardstick the port never
    calls), bit for bit between two runs, and over uneven, empty and
    one-expert routings; K5 at (4, 32/8, 2,048, 128) bf16 with the scale
    1/128 against its plain version; K8 (``kernels.ssd_scan``) at the
    cell's Mamba-2 shape (:func:`granite_k8`); K9 (``kernels.moe_combine``)
    at the cell's combine shape (:func:`granite_k9`); and one decision of
    the benchmark cell through the program (:func:`granite_served`), whose
    K7, K8 and K9 launches are their ``launches``.  Standalone: ``python3
    chip_smoke.py --granite``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_grouped import (flops, min_bytes,
                                                 moe_grouped)
    from repro_torch.kernels.ref import attention_ref, moe_grouped_ref
    built = _build.build(["moe_grouped", "flash_attention", "ssd_scan",
                          "moe_combine"])
    for name, info in built.items():
        for line in info["log"].splitlines():
            if any(w in line.lower() for w in ("registers", "smem", "spill",
                                                "warning", "error")):
                print(f"  ptxas {name}: {line.strip()}")
    out = {"card": card}
    g = torch.Generator(device=dev).manual_seed(22)
    E, K, T, D, Fd = 72, 10, 8192, 4096, 768

    def weights():
        w = [torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(
            0.0, shape[1] ** -0.5, generator=g)
            for shape in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
        return w

    def routed(counts):
        """Rows sorted by expert for the given per-expert counts."""
        M = int(sum(counts))
        x = torch.randn((M, D), generator=g, device=dev).to(torch.bfloat16)
        off = torch.zeros(E + 1, dtype=torch.int32, device=dev)
        off[1:] = torch.tensor(counts, device=dev).cumsum(0)
        scale = torch.rand(M, generator=g, device=dev)
        return x, off, scale

    wg, wu, wd = weights()
    logits = torch.randn((T, E), generator=g, device=dev)
    idx = torch.topk(logits, K, dim=-1).indices.reshape(-1)
    counts = torch.bincount(idx, minlength=E).tolist()
    x, off, scale = routed(counts)
    M = x.shape[0]

    def k7():
        return moe_grouped(x, off, wg, wu, wd, row_scale=scale)

    def plain():
        return moe_grouped_ref(x, off, wg, wu, wd, scale)

    moe_grouped.launches = 0
    got = k7()
    torch.cuda.synchronize()
    check(moe_grouped.launches == 1, "K7 did not launch")
    want = plain()
    def gap(got, want):
        """(||got - want|| / ||want||, max |got - want|, RMS of want)."""
        d = got - want
        return ((d.norm() / want.norm()).item(), d.abs().max().item(),
                want.square().mean().sqrt().item())

    rel, err, rms = gap(got, want)
    q = torch.quantile((got - want).abs().flatten()[::97].float(),
                       torch.tensor([0.5, 0.999], device=dev)).tolist()
    print(f"K7 at {M} rows over {E} experts (rows an expert "
          f"{min(counts)}-{max(counts)}), D {D}, F {Fd}: ||K7 - plain|| / "
          f"||plain|| {rel:.4g} (limit {K7_REL:.4g}), max |K7 - plain| "
          f"{err:.4g}, output RMS {rms:.4g} (limit {K7_MAX * rms:.4g}); "
          f"|K7 - plain| median {q[0]:.3g}, 99.9th percentile {q[1]:.3g}")
    check(rel <= K7_REL and err <= K7_MAX * rms,
          f"K7 off its plain version: {rel}, {err} over {K7_MAX} x {rms}")
    check(torch.equal(got, k7()), "K7 is not bit for bit between two runs")
    rolled = moe_grouped(x, off, wg.roll(1, 0), wu.roll(1, 0),
                         wd.roll(1, 0), row_scale=scale)
    wrong = gap(rolled, want)[0]
    check(wrong > 100 * K7_REL, f"K7 with each expert's weights moved to "
          f"the next expert reads {wrong}, within the limit")
    lib = None
    try:
        offs = off[1:].contiguous()

        def library():
            gm = torch._grouped_mm
            h = (torch.nn.functional.silu(gm(x, wg, offs=offs).float())
                 * gm(x, wu, offs=offs).float()).to(torch.bfloat16)
            return gm(h, wd, offs=offs).float() * scale[:, None]
        lib_rel, lib_err, _ = gap(library(), want)
        lib = cuda_ms(library, iters=10, warmup=2)
        print(f"torch._grouped_mm: {lib:.4f} ms, ||lib - plain|| / ||plain|| "
              f"{lib_rel:.4g}, max |lib - plain| {lib_err:.4g}")
    except (AttributeError, RuntimeError, TypeError) as e:
        print(f"torch._grouped_mm: not available here ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:160]})")
    ms = cuda_ms(k7, iters=20, warmup=3)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    dev_us = kernel_device_us(k7, "moe_grouped_kernel", calls=10)
    b_ms, b_by = bound(min_bytes(M, D, Fd, E), flops(M, D, Fd),
                       PEAK_BF16_FLOP_S)
    k7_dev_ms = None if dev_us is None else dev_us[0] * dev_us[1] / 1e3
    print(f"K7: {ms:.4f} ms a call (events, 20 calls; device "
          f"{k7_dev_ms if k7_dev_ms is None else round(k7_dev_ms, 4)} ms "
          f"in {None if dev_us is None else dev_us[1]} kernels), bound "
          f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of it; plain "
          f"{plain_ms:.4f} ms; {flops(M, D, Fd) / ms / 1e9:.1f} TFLOP/s")
    out["k7"] = dict(rows=M, experts=E, d_model=D, d_ff=Fd,
                     rows_per_expert=[min(counts), max(counts)],
                     rel_err=rel, max_abs_err=err, out_rms=rms,
                     wrong_expert_rel_err=wrong,
                     ms=ms, device_ms=k7_dev_ms, plain_ms=plain_ms,
                     library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                     phase_launches=moe_grouped.launches)
    # uneven routings: empty experts, partial tiles, one expert taking all
    for label, cnt in (("uneven", [0, 1, 127, 128, 129, 300, 0, 5]
                        + [17] * (E - 8)),
                       ("one expert", [0] * 5 + [3000] + [0] * (E - 6))):
        x, off, scale = routed(cnt)
        got = moe_grouped(x, off, wg, wu, wd, row_scale=scale)
        want = moe_grouped_ref(x, off, wg, wu, wd, scale)
        rel_, e_, r_ = gap(got, want)
        print(f"K7 {label} ({x.shape[0]} rows): ||K7 - plain|| / ||plain|| "
              f"{rel_:.4g}, max |K7 - plain| {e_:.4g}, RMS {r_:.4g}")
        check(rel_ <= K7_REL and e_ <= K7_MAX * r_,
              f"K7 {label}: {rel_}, {e_} over {K7_MAX} x {r_}")
        out[f"k7_{label.replace(' ', '_')}_rel_err"] = rel_
    del x, wg, wu, wd, got, want, rolled

    # K5 at granite-4.0-h's attention shape and scale
    B, H, Hkv, S, hd = 4, 32, 8, 2048, 128
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    sc = 1 / 128
    flash_attention.launches = 0
    got = flash_attention(q, k, v, causal=True, scale=sc)
    rep = H // Hkv
    kr, vr = k.repeat_interleave(rep, 1).float(), v.repeat_interleave(
        rep, 1).float()
    want = attention_ref(q.float(), kr, vr, causal=True, scale=sc)
    default = attention_ref(q.float(), kr, vr, causal=True)
    def rel(got, want):
        return ((got.float() - want).norm() / want.norm()).item()

    k5_err = (got.float() - want).abs().max().item()
    k5_rel, off_rel = rel(got, want), rel(got, default)
    print(f"K5 at ({B}, {H}/{Hkv}, {S}, {hd}) bf16, scale 1/128: ||K5 - "
          f"plain|| / ||plain|| {k5_rel:.4g} (limit {K5_WINDOW_RTOL:.4g}), "
          f"max |K5 - plain| {k5_err:.4g}; against plain at head_dim ** "
          f"-0.5 {off_rel:.4g}")
    check(flash_attention.launches == 1, "K5 did not launch")
    check(k5_rel <= K5_WINDOW_RTOL, f"K5 at scale 1/128: {k5_rel}")
    check(off_rel > 10 * K5_WINDOW_RTOL, "K5's scale does not act")
    k5_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True, scale=sc),
                    iters=20)
    plain_k5 = cuda_ms(lambda: attention_ref(q.float(), kr, vr, causal=True,
                                             scale=sc), iters=3, warmup=1)
    lib_k5 = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc, enable_gqa=True), iters=20)
    k5_flops = 4 * B * H * hd * attention_pairs(S, None)
    k5_b, k5_by = bound(nbytes(q, k, v) + nbytes(q), k5_flops,
                        PEAK_BF16_FLOP_S)
    print(f"K5 granite shape: {k5_ms:.4f} ms, bound {k5_b:.4f} ms "
          f"({k5_by}), {100 * k5_b / k5_ms:.1f}% of it; plain "
          f"{plain_k5:.4f} ms; scaled_dot_product_attention {lib_k5:.4f} ms")
    out["k5"] = dict(shape=[B, H, Hkv, S, hd], scale=sc, max_abs_err=k5_err,
                     rel_err=k5_rel, default_scale_rel_err=off_rel,
                     ms=k5_ms, plain_ms=plain_k5,
                     library_ms=lib_k5, bound_ms=k5_b, bound_by=k5_by)
    del q, k, v, kr, vr, got, want, default
    out["k8"] = granite_k8(dev, g)
    out["k9"] = granite_k9(dev, g)
    served = granite_served(dev)
    out["served"] = served
    out["k7"]["launches"] = served["k7_launches"]
    out["k5"]["served_launches"] = served["k5_launches"]
    out["k8"]["launches"] = served["k8_launches"]
    out["k9"]["launches"] = served["k9_launches"]
    return out


def granite_main() -> int:
    """``python3 chip_smoke.py --granite``: phase 22 alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    print(card)
    out = granite_phase(torch.device("cuda"), card)
    print(json.dumps({"granite": out}, default=float))
    return 0


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
    from repro_torch import deploy as deploy_cli
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.miniconv_pass import (miniconv_encoder,
                                                   miniconv_encoder_stream,
                                                   miniconv_layer_grouped,
                                                   miniconv_pass)
    from repro_torch.kernels.ops import same_pad
    from repro_torch.kernels.ref import (attention_ref, miniconv_encoder_ref,
                                         miniconv_encoder_stream_ref,
                                         miniconv_layer_grouped_ref,
                                         miniconv_pass_ref)
    from repro_torch.core.miniconv import _ACTS
    from repro_torch.rl.networks import (squashed_actor_init,
                                         squashed_actor_mode)

    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # cuDNN defaults to TF32 for fp32 convolutions, which would make the
    # plain version the inexact side of every comparison.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    # phase 20's lint runs beside phases 1 onward; it never outlives this
    # process
    lint = start_lint()
    atexit.register(lambda: lint[0].poll() is None and lint[0].kill())

    # ---- 1. build ----------------------------------------------------------
    # repro: allow(timing-warmup) -- times nvcc's build of the kernels: host processes, no device work in the window
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(built) or 'nothing (cached)'}")
    for name, info in built.items():
        if name == "miniconv_layer":
            continue
        for line in info["log"].splitlines():
            if any(w in line.lower() for w in ("registers", "smem", "spill",
                                                "wgmma", "warning")):
                print(f"  ptxas {name}: {line.strip()}")
    if "miniconv_layer" in built:
        report = layer_ptxas(built["miniconv_layer"]["log"])
        check(len(report) == 28, f"ptxas reported {len(report)} layer "
              f"kernels, expected 28 (8 K2 and 20 K3 instantiations)")
        for kname, regs, st, ld in report:
            print(f"  ptxas miniconv_layer: {kname} {regs} registers, "
                  f"{st} B spill stores, {ld} B spill loads")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    check(hgmma > 0, "K5's SASS holds no HGMMA: the bf16 route is not on "
          "the tensor cores")
    print(f"K5 SASS: {hgmma} HGMMA instructions (cuobjdump -sass)")

    wrappers = (miniconv_encoder, miniconv_pass, miniconv_layer_grouped,
                miniconv_encoder_stream, flash_attention)

    def reset_counts():
        for f in wrappers:
            f.launches = 0
        flash_attention.tc_launches = flash_attention.copies = 0
        miniconv_pass.copies = miniconv_layer_grouped.copies = 0

    def counts():
        """Launches per kernel since the last reset, K1..K5 in order."""
        return tuple(f.launches for f in wrappers)

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

    def library_chain(x, ws, bs, plan, head_w=None, head_b=None,
                      head_act="relu"):
        """The same function through library calls, a yardstick only, never
        called by the port: the cuDNN F.conv2d chain on NCHW inputs
        prepared beforehand and, with a head, the projection by
        torch.matmul on the NHWC flatten."""
        xn = x.permute(0, 3, 1, 2).contiguous()
        wn = [w.permute(3, 2, 0, 1).contiguous() for w in ws]

        def run():
            y = xn
            for l, w, b in zip(plan.layers, wn, bs):
                y = F.pad(y, (l.pad_left, l.pad_right, l.pad_top,
                              l.pad_bottom))
                y = _ACTS[l.activation](F.conv2d(y, w, b, stride=l.stride))
            if head_w is None:
                return y
            flat = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
            z = torch.matmul(flat, head_w)
            return y, _ACTS[head_act](z if head_b is None else z + head_b)
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
        ("400x400", standard_spec(c_in=4, k=4), 2, 400, 400, None,
         "relu"),
        ("odd", odd, 3, 85, 83, 200, "sigmoid"),
        # a trained policy's shapes: three stacked RGB frames (phase 14)
        ("train served", standard_spec(c_in=9, k=4), 1, 84, 84, None,
         "relu"),
        ("train batch+head", standard_spec(c_in=9, k=4), 8, 84, 84, 512,
         "relu"),
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
        # five event readings of each (a mean over 50 calls each); the
        # median is the row's time, so one host stall does not set it
        ms_reps = [cuda_ms(kern) for _ in range(5)]
        plain_reps = [cuda_ms(plain) for _ in range(5)]
        ms, plain_ms = median(ms_reps), median(plain_reps)
        lib_ms = cuda_ms(library_chain(x, ws, bs, plan, hw, hb, act))
        dev_us = kernel_device_us(kern, "encoder_kernel")
        dev_us = dev_us and dev_us[0]
        flops = plan.flops_per_batch(B, plan.head(D) if D else None)
        b_ms, b_by = bound(nbytes(x, *ws, *bs, hw, hb, feats, z), flops)
        tp = plan.tile_plan(B)
        print(f"K1 miniconv_encoder {label} x={tuple(x.shape)} head={D} "
              f"tiles {tp.tile_h}x{tp.tile_w}, {tp.n_tiles} a frame, "
              f"{B * tp.n_tiles} blocks of {tp.smem_bytes} B shared memory "
              f"(recompute {tp.recompute(plan):.2f}x): max_abs_err feats "
              f"{err:.3g} (tol {FEAT_TOL})"
              + (f" z {zerr:.3g} (tol {Z_TOL})" if zerr is not None else "")
              + f"; kernel {ms:.4f} ms (device "
              + ("not measured" if dev_us is None else f"{dev_us:.2f} us")
              + " a launch, traced; median of "
              + "/".join(f"{t:.4f}" for t in ms_reps)
              + f"), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (cuDNN chain"
              + (" + matmul head" if D else "") + f"), bound {b_ms:.5f} ms "
              f"({b_by})")
        k1_rows[label] = dict(max_abs_err=max(err, zerr or 0.0), ms=ms,
                              ms_reps=ms_reps, plain_ms_reps=plain_reps,
                              device_us=dev_us, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              library_ms=lib_ms, shape=list(x.shape), head=D,
                              tile=[tp.tile_h, tp.tile_w],
                              tiles=tp.n_tiles)
    check(k1_rows["served edge"]["tiles"] >= 36,
          "the served 84x84 frame must spread over at least 36 blocks")

    # K2 on each layer of the standard plan, at the served shape (1 frame),
    # at a batch of 8 and at two 400x400x4 frames, on each group's weight
    # view as the reference tier passes it; the inputs are the plain
    # chain's layer inputs.
    from repro_torch.core.passplan import plan_conv_tiles

    def plan_note(x, w, stride, grouped):
        B, h_in, w_in, c_in = x.shape
        kh, kw, _, c_out = w.shape
        tp = plan_conv_tiles(B, (h_in - kh) // stride + 1,
                             (w_in - kw) // stride + 1, kh, kw, stride,
                             c_in, c_out, grouped)
        return (f"{tp.tile_h}x{tp.tile_w}x{tp.co_block} tiles, "
                f"({tp.pix},{tp.cb}) a thread, {tp.blocks} blocks of "
                f"{tp.threads}")

    p_std, _, _ = layer_params(std, 77)
    k2_rows = {}
    for label, B, H, c_in, iters in (("served edge", 1, 84, 12, 50),
                                     ("batch", 8, 84, 12, 50),
                                     ("400x400", 2, 400, 4, 10)):
        spec = standard_spec(c_in=c_in, k=4)
        lplan = spec.plan(H)
        _, ws2, bs2 = layer_params(spec, 77 + B)
        y = rand((B, H, H, c_in), 78)
        launches, k2_err, notes = [], 0.0, []
        miniconv_pass.copies = 0
        for l, w, b in zip(lplan.layers, ws2, bs2):
            xp = same_pad(y, l.kernel, l.stride)
            wp = F.pad(w, (0, (-l.c_out) % 4))
            bp = F.pad(b, (0, (-l.c_out) % 4))
            notes.append(plan_note(xp, wp[..., :4], l.stride, False))
            for g in range(0, wp.shape[-1], 4):
                wg, bg = wp[..., g:g + 4], bp[g:g + 4]
                got = miniconv_pass(xp, wg, bg, stride=l.stride)
                want = miniconv_pass_ref(xp, wg, bg, stride=l.stride)
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                check(torch.allclose(got, want, atol=FEAT_TOL,
                                     rtol=FEAT_TOL),
                      f"K2 layer {l.index} group {g // 4} {label}: differs "
                      f"by {e} (tol {FEAT_TOL})")
                check(torch.equal(got, miniconv_pass(xp, wg, bg,
                                                     stride=l.stride)),
                      f"K2 layer {l.index} {label}: two runs differ")
                k2_err = max(k2_err, e)
                launches.append((xp, wg, bg, l.stride, got))
            y = _ACTS[l.activation](miniconv_pass_ref(xp, w, b,
                                                      stride=l.stride))
        check(len(launches) == lplan.total_passes == 9,
              f"K2: {len(launches)} passes, expected 9")
        check(miniconv_pass.copies == 0, f"K2 {label}: "
              f"{miniconv_pass.copies} inputs copied, expected 0")
        lib_in = [(xp.permute(0, 3, 1, 2).contiguous(),
                   wg.permute(3, 2, 0, 1).contiguous(), bg.contiguous(), s)
                  for xp, wg, bg, s, _ in launches]
        ms = cuda_ms(lambda: [miniconv_pass(xp, wg, bg, stride=s)
                              for xp, wg, bg, s, _ in launches], iters=iters)
        plain_ms = cuda_ms(lambda: [miniconv_pass_ref(xp, wg, bg, stride=s)
                                    for xp, wg, bg, s, _ in launches],
                           iters=iters)
        lib_ms = cuda_ms(lambda: [F.conv2d(xn, wn, bn, stride=s)
                                  for xn, wn, bn, s in lib_in], iters=iters)
        # each pass reads its layer's input and its group's weights once
        b_ms, b_by = bound(sum(nbytes(xp, bg, out) + 4 * wg.numel()
                               for xp, wg, bg, _, out in launches),
                           B * lplan.flops_per_frame)
        row = dict(max_abs_err=k2_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   shape=[B, H, H, c_in], plans=notes)
        host = ""
        if label == "served edge":   # the wrappers' host and device time
            xp, wg, bg, s, _ = launches[0]
            xn, wn, bn, _ = lib_in[0]
            row["host_us"] = host_us(lambda: miniconv_pass(xp, wg, bg,
                                                           stride=s))
            row["library_host_us"] = host_us(lambda: F.conv2d(xn, wn, bn,
                                                              stride=s))
            lib = kernel_device_us(lambda: [F.conv2d(xn, wn, bn, stride=s)
                                            for xn, wn, bn, s in lib_in])
            # per F.conv2d call: (device us, kernels)
            lib = lib and (lib[0] * lib[1] / 9, lib[1] / 9)
            row["library_device_us"] = lib and lib[0]
            host = (f"; host {row['host_us']:.2f} us a call (layer 0, "
                    f"group 0), F.conv2d {row['library_host_us']:.2f} us; "
                    f"F.conv2d traced: " + (
                        "not measured" if lib is None else
                        f"{lib[0]:.2f} us of device time a call, "
                        f"{lib[1]:.2f} kernels a call"))
        print(f"K2 miniconv_pass {label}: the 9 passes of the standard plan "
              f"at ({B},{H},{H},{c_in}), weight group views, 0 copies: "
              f"max_abs_err {k2_err:.3g} (tol {FEAT_TOL}), repeats bit for "
              f"bit; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (9 F.conv2d), bound {b_ms:.5f} ms ({b_by}) "
              f"for 9 launches{host}; plans by layer: " + "; ".join(notes))
        k2_rows[label] = row

    # One hand kernel against the other: the per-pass tier against the
    # fused tier, both on the card.
    xb = rand((8, 84, 84, 12), 79)
    per_pass = miniconv_apply(p_std, std, xb, use_kernel="reference")
    fused = miniconv_apply(p_std, std, xb, use_kernel="fused",
                           plan=std.plan(84))
    torch.cuda.synchronize()
    e = (per_pass - fused).abs().max().item()
    check(torch.allclose(per_pass, fused, atol=FEAT_TOL, rtol=FEAT_TOL),
          f"reference tier vs fused tier differ by {e}")
    print(f"K2 chain (reference backend) vs K1 (fused) at (8,84,84,12): "
          f"max_abs_err {e:.3g} (tol {FEAT_TOL})")

    # K3 on each layer of the standard plan: at the served shape (1 frame),
    # at a batch of 8, and at 400x400x4; the inputs are the plain chain's
    # layer inputs.
    k3_rows = {}
    for label, B, H, c_in, iters in (("served edge", 1, 84, 12, 50),
                                     ("batch", 8, 84, 12, 50),
                                     ("400x400", 2, 400, 4, 10)):
        spec = standard_spec(c_in=c_in, k=4)
        lplan = spec.plan(H)
        _, ws3, bs3 = layer_params(spec, 200 + B)
        y = rand((B, H, H, c_in), 201 + B)
        launches, k3_err, notes = [], 0.0, []
        miniconv_layer_grouped.copies = 0
        for l, w, b in zip(lplan.layers, ws3, bs3):
            xp = same_pad(y, l.kernel, l.stride)
            notes.append(plan_note(xp, w, l.stride, True))
            got = miniconv_layer_grouped(xp, w, b, stride=l.stride)
            want = miniconv_layer_grouped_ref(xp, w, b, stride=l.stride)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            check(got.shape == want.shape and torch.allclose(
                got, want, atol=FEAT_TOL, rtol=FEAT_TOL),
                f"K3 layer {l.index} {label}: differs by {e} (tol "
                f"{FEAT_TOL})")
            check(torch.equal(got, miniconv_layer_grouped(
                xp, w, b, stride=l.stride)),
                f"K3 layer {l.index} {label}: two runs differ")
            k3_err = max(k3_err, e)
            launches.append((xp, w, b, l.stride, got))
            y = _ACTS[l.activation](want)
        check(miniconv_layer_grouped.copies == 0, f"K3 {label}: "
              f"{miniconv_layer_grouped.copies} inputs copied, expected 0")
        lib_in = [(xp.permute(0, 3, 1, 2).contiguous(),
                   w.permute(3, 2, 0, 1).contiguous(), b, st)
                  for xp, w, b, st, _ in launches]
        ms = cuda_ms(lambda: [miniconv_layer_grouped(xp, w, b, stride=st)
                              for xp, w, b, st, _ in launches], iters=iters)
        plain_ms = cuda_ms(lambda: [miniconv_layer_grouped_ref(
            xp, w, b, stride=st) for xp, w, b, st, _ in launches],
            iters=iters)
        lib_ms = cuda_ms(lambda: [F.conv2d(xn, wn, b, stride=st)
                                  for xn, wn, b, st in lib_in], iters=iters)
        b_ms, b_by = bound(sum(nbytes(xp, w, b, out)
                               for xp, w, b, _, out in launches),
                           B * lplan.flops_per_frame)
        row = dict(max_abs_err=k3_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   shape=[B, H, H, c_in], plans=notes)
        host = ""
        if label == "served edge":   # the wrappers' host and device time
            xp, w, b, st, _ = launches[0]
            xn, wn, _, _ = lib_in[0]
            row["host_us"] = host_us(lambda: miniconv_layer_grouped(
                xp, w, b, stride=st))
            row["library_host_us"] = host_us(lambda: F.conv2d(xn, wn, b,
                                                              stride=st))
            lib = kernel_device_us(lambda: [F.conv2d(xn, wn, b, stride=st)
                                            for xn, wn, b, st in lib_in])
            # per F.conv2d call: (device us, kernels)
            lib = lib and (lib[0] * lib[1] / 3, lib[1] / 3)
            row["library_device_us"] = lib and lib[0]
            host = (f"; host {row['host_us']:.2f} us a call (layer 0), "
                    f"F.conv2d {row['library_host_us']:.2f} us; F.conv2d "
                    f"traced: " + (
                        "not measured" if lib is None else
                        f"{lib[0]:.2f} us of device time a call, "
                        f"{lib[1]:.2f} kernels a call"))
        print(f"K3 miniconv_layer_grouped {label}: the 3 layers at "
              f"({B},{H},{H},{c_in}), 0 copies: max_abs_err {k3_err:.3g} "
              f"(tol {FEAT_TOL}), repeats bit for bit; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (3 "
              f"F.conv2d), bound {b_ms:.5f} ms ({b_by}) for 3 launches"
              f"{host}; plans by layer: " + "; ".join(notes))
        k3_rows[label] = row
    grouped = miniconv_apply(p_std, std, xb, use_kernel="grouped")
    torch.cuda.synchronize()
    check(torch.equal(grouped, per_pass),
          "grouped tier differs from the reference tier (must be bitwise)")
    print("K3 chain (grouped backend) vs K2 chain (reference backend) at "
          "(8,84,84,12): bitwise equal")

    # K4 against K1 (bit for bit) and against the plain version, each call
    # one K4 launch: 33 frames of 400x400 with the plan's chunk (a ragged
    # last round of tiles), and 8 frames of 84x84 in chunks of 3.
    for label, spec, B, H, D, chunk in (
            ("400x400", standard_spec(c_in=4, k=4), 33, 400, 512, None),
            ("84x84", std, 8, 84, None, 3)):
        splan = spec.plan(H)
        chunk = chunk or splan.max_safe_batch()
        _, ws4, bs4 = layer_params(spec, 300 + B)
        x4 = rand((B, H, H, spec.layers[0].c_in), 301 + B)
        hw = hb = None
        if D is not None:
            hw = randn((splan.flat_features, D), 302 + B, 0.05)
            hb = randn((D,), 303 + B, 0.1)
        reset_counts()
        out = miniconv_encoder_stream(x4, ws4, bs4, splan, chunk_b=chunk,
                                      head_w=hw, head_b=hb)
        torch.cuda.synchronize()
        check(counts() == (0, 0, 0, 1, 0),
              f"K4 {label}: launches K1..K5 {counts()}, expected one K4")
        whole = miniconv_encoder(x4, ws4, bs4, splan, head_w=hw, head_b=hb)
        ref = miniconv_encoder_stream_ref(x4, ws4, bs4, splan, head_w=hw,
                                          head_b=hb)
        torch.cuda.synchronize()
        out, whole, ref = ((out, whole, ref) if D is not None
                           else ((out, None), (whole, None), (ref, None)))
        check(torch.equal(out[0], whole[0])
              and (D is None or torch.equal(out[1], whole[1])),
              f"K4 {label}: differs from K1 (must be bitwise)")
        err = (out[0] - ref[0]).abs().max().item()
        check(torch.allclose(out[0], ref[0], atol=FEAT_TOL, rtol=FEAT_TOL),
              f"K4 {label}: features differ from plain by {err}")
        zerr = None
        if D is not None:
            zerr = (out[1] - ref[1]).abs().max().item()
            check(torch.allclose(out[1], ref[1], atol=Z_TOL, rtol=Z_TOL),
                  f"K4 {label}: z differs from plain by {zerr}")
        tp4 = splan.tile_plan(B, streamed=True)
        print(f"K4 miniconv_encoder_stream {label} x={tuple(x4.shape)} "
              f"chunk {chunk} head={D}, {B * tp4.n_tiles} tiles of "
              f"{tp4.tile_h}x{tp4.tile_w} over "
              f"{tp4.stream_blocks(B, chunk)} blocks: one "
              f"K4 launch, bitwise equal to K1; vs plain max_abs_err feats "
              f"{err:.3g} (tol {FEAT_TOL})"
              + (f" z {zerr:.3g} (tol {Z_TOL})" if zerr is not None else ""))

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
    reset_counts()
    payloads = [client.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions = torch.stack(server.serve(payloads))
    torch.cuda.synchronize()
    fused_launches = miniconv_encoder.launches
    check(counts() == (8, 0, 0, 0, 0), f"fused serve launched K1..K5 "
          f"{counts()} times; expected (8, 0, 0, 0, 0)")
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
    reset_counts()
    with torch.inference_mode():
        z_h = dep_h.encoder.apply(params, obs)
        torch.cuda.synchronize()
        z_x = dep_x.encoder.apply(params, obs)
    check(counts() == (1, 0, 0, 0, 0), f"fused+head launched K1..K5 "
          f"{counts()} times for one batch; expected (1, 0, 0, 0, 0)")
    zerr = (z_h - z_x).abs().max().item()
    check(torch.allclose(z_h, z_x, atol=Z_TOL, rtol=Z_TOL),
          f"fused+head vs xla z differ by {zerr}")
    print(f"fused+head: encoder.apply on 8 frames, K1 launches 1; z vs xla "
          f"max_abs_err {zerr:.3g} (tol {Z_TOL})")

    dep_r = Deployment.build(dataclasses.replace(cfg, backend="reference"))
    client_r, server_r = dep_r.serving_pair(params, head)
    reset_counts()
    payload_r = client_r.encode_fn(obs[0:1])
    action_r = server_r.serve([payload_r])[0]
    torch.cuda.synchronize()
    ref_launches = miniconv_pass.launches
    check(counts() == (0, 9, 0, 0, 0), f"reference serve launched K1..K5 "
          f"{counts()} times; expected (0, 9, 0, 0, 0)")
    ref_copies = miniconv_pass.copies
    check(ref_copies == 0, f"reference serve copied {ref_copies} K2 inputs "
          f"(expected 0: the group weights are read as views)")
    r_err = (action_r - actions[0]).abs().max().item()
    check(r_err <= ACT_TOL, f"reference vs fused action differ by {r_err}")
    a_err = (action_r - actions_x[0]).abs().max().item()
    check(a_err <= ACT_TOL, f"reference vs xla action differ by {a_err}")
    print(f"serve reference: 1 request, K2 launches {ref_launches}, copies "
          f"{ref_copies}; action vs fused max_abs_err {r_err:.3g}, vs xla "
          f"build {a_err:.3g} (tol {ACT_TOL})")
    k2_us = kernel_device_us(
        lambda: server_r.serve([client_r.encode_fn(obs[0:1])]),
        "pass_kernel", calls=10)
    k2_us = k2_us and k2_us[0]
    print("serve reference traced: K2 "
          + ("not measured" if k2_us is None else f"{k2_us:.2f} us")
          + " of device time a launch (mean of a request's 9 passes; the "
          f"first-draft K2: {FIRST_K2_US} us), against "
          f"{1e3 * k2_rows['served edge']['ms'] / 9:.2f} us a launch by CUDA "
          "events in phase 2")

    # ---- 5. the grouped path -----------------------------------------------
    dep_g = Deployment.build(dataclasses.replace(cfg, backend="grouped"))
    client_g, server_g = dep_g.serving_pair(params, head)
    reset_counts()
    payloads_g = [client_g.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions_g = torch.stack(server_g.serve(payloads_g))
    torch.cuda.synchronize()
    grouped_launches = miniconv_layer_grouped.launches
    check(counts() == (0, 0, 24, 0, 0), f"grouped serve launched K1..K5 "
          f"{counts()} times; expected (0, 0, 24, 0, 0)")
    g_err = (actions_g - actions_x).abs().max().item()
    check(g_err <= ACT_TOL, f"grouped vs xla actions differ by {g_err}")
    print(f"serve grouped: 8 requests, K3 launches {grouped_launches}; "
          f"actions vs xla build max_abs_err {g_err:.3g} (tol {ACT_TOL})")
    k3_us = kernel_device_us(
        lambda: server_g.serve([client_g.encode_fn(obs[0:1])]),
        "layer_grouped_kernel", calls=10)
    k3_us = k3_us and k3_us[0]
    print("serve grouped traced: K3 "
          + ("not measured" if k3_us is None else f"{k3_us:.2f} us")
          + " of device time a launch (mean of a request's 3 layers; the "
          f"first-draft K3: {FIRST_K3_US} us), against "
          f"{1e3 * k3_rows['served edge']['ms'] / 3:.2f} us a launch by "
          "CUDA events in phase 2")

    # ---- 6. tune the served manifest on the card, serve the tuned build --
    manifest = ROOT / "build" / "tuned_manifest.json"
    manifest.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    deploy_cli.main(["--k", "4", "--c-in", "12", "--x", "84",
                     "--max-batch", "8", "--backend", "fused", "--tune",
                     "--out", str(manifest), "--verify"])
    tune_s = time.perf_counter() - t0
    tuned_cfg = DeploymentConfig.from_json(manifest.read_text())
    tp = tuned_cfg.tuning
    check(tp is not None and tp.mode == "cuda",
          f"tuned manifest mode {tp and tp.mode!r}, expected 'cuda'")
    dep_t = Deployment.build(tuned_cfg)
    check(any("manifest TunedPlan" in line for line in dep_t.build_log),
          f"tuned build ignored its TunedPlan: {dep_t.build_log}")
    client_t, server_t = dep_t.serving_pair(params, head)
    reset_counts()
    payloads_t = [client_t.encode_fn(obs[i:i + 1]) for i in range(8)]
    actions_t = torch.stack(server_t.serve(payloads_t))
    torch.cuda.synchronize()
    tuned_counts = counts()
    t_err = (actions_t - actions_x).abs().max().item()
    check(t_err <= ACT_TOL, f"tuned vs xla actions differ by {t_err}")
    print(f"tune: {tune_s:.2f} s, winner backend={tp.backend} "
          f"micro_batch={tp.micro_batch} ({tp.per_frame_s * 1e6:.1f} "
          f"us/frame, searched {tp.searched}, pruned {tp.pruned}); tuned "
          f"build served 8 requests, launches K1..K5 {tuned_counts}, "
          f"actions vs xla max_abs_err {t_err:.3g} (tol {ACT_TOL})")

    # ---- 7. config B: 64 frames of 400x400x4 through fused+stream ----------
    cfg_b = DeploymentConfig.standard(k=4, c_in=4, h=400,
                                      backend="fused+stream", max_batch=64)
    dep_b = Deployment.build(cfg_b)
    for line in dep_b.build_log:
        print(f"build_log B: {line}")
    chunkB = dep_b.stream_chunk
    check(chunkB == dep_b.max_safe_batch < 64,
          f"config B: max_safe_batch {dep_b.max_safe_batch}, stream_chunk "
          f"{chunkB}: 64 frames must stream")
    params_b = dep_b.init(gen(5))
    xB = rand((64, 400, 400, 4), 6)
    reset_counts()
    with torch.inference_mode():
        z_b = dep_b.encoder.apply(params_b, xB)
    torch.cuda.synchronize()
    stream_launches = miniconv_encoder_stream.launches
    check(counts() == (0, 0, 0, 1, 0), f"config B launched K1..K5 "
          f"{counts()} times; expected (0, 0, 0, 1, 0)")
    dep_bh = Deployment.build(dataclasses.replace(cfg_b,
                                                  backend="fused+head"))
    check(dep_bh.stream_chunk == chunkB,
          "fused+head at config B must stream")
    pB = params_b["edge"]
    wsB = [pB[f"layer{i}"]["kernel"] for i in range(3)]
    bsB = [pB[f"layer{i}"]["bias"] for i in range(3)]
    hwB = params_b["server"]["proj"]["kernel"]
    hbB = params_b["server"]["proj"]["bias"]
    planB = dep_b.plan
    with torch.inference_mode():
        fB, z_k1 = miniconv_encoder(xB, wsB, bsB, planB, head_w=hwB,
                                    head_b=hbB)
        rfB, rzB = miniconv_encoder_stream_ref(xB, wsB, bsB, planB,
                                               head_w=hwB, head_b=hbB)
    torch.cuda.synchronize()
    check(torch.equal(z_b, z_k1), "config B: K4 z differs from K1's "
          "(the fused+head kernel in one 64-block launch): must be bitwise")
    errB = (z_b - rzB).abs().max().item()
    check(torch.allclose(z_b, rzB, atol=Z_TOL, rtol=Z_TOL),
          f"config B: z differs from plain by {errB}")
    with torch.inference_mode():
        k4_ms = cuda_ms(lambda: miniconv_encoder_stream(
            xB, wsB, bsB, planB, chunk_b=chunkB, head_w=hwB, head_b=hbB),
            iters=10, warmup=2)
        k1_ms = cuda_ms(lambda: miniconv_encoder(
            xB, wsB, bsB, planB, head_w=hwB, head_b=hbB), iters=10,
            warmup=2)
        plainB_ms = cuda_ms(lambda: miniconv_encoder_stream_ref(
            xB, wsB, bsB, planB, head_w=hwB, head_b=hbB), iters=3, warmup=1)
        libB_ms = cuda_ms(library_chain(xB, wsB, bsB, planB, hwB, hbB),
                          iters=10, warmup=2)
        k4_us = kernel_device_us(lambda: miniconv_encoder_stream(
            xB, wsB, bsB, planB, chunk_b=chunkB, head_w=hwB, head_b=hbB),
            "encoder_stream_kernel", calls=5)
        k4_us = k4_us and k4_us[0]
    flopsB = planB.flops_per_batch(64, planB.head(hwB.shape[1]))
    bB_ms, bB_by = bound(nbytes(xB, *wsB, *bsB, hwB, hbB, fB, z_b), flopsB)
    tpB = planB.tile_plan(64, streamed=True)
    print(f"config B: encoder.apply on (64,400,400,4), {xB.numel() * 4} B "
          f"of input, fused+stream chunk {chunkB}: K4 launches "
          f"{stream_launches} ({64 * tpB.n_tiles} tiles of {tpB.tile_h}x"
          f"{tpB.tile_w} over {tpB.stream_blocks(64, chunkB)} blocks), z "
          f"bitwise equal to fused+head's K1 launch; vs plain "
          f"max_abs_err z {errB:.3g} (tol {Z_TOL}); K4 {k4_ms:.4f} ms (device "
          + ("not measured" if k4_us is None else f"{k4_us / 1e3:.4f} ms")
          + f", traced), K1 {k1_ms:.4f} ms, plain {plainB_ms:.4f} ms, "
          f"library {libB_ms:.4f} ms (cuDNN chain + matmul head), bound "
          f"{bB_ms:.5f} ms ({bB_by}); {flopsB / k4_ms / 1e9:.2f} TFLOP/s")
    del xB, fB, z_b, z_k1, rfB, rzB

    # ---- 8. K5 against its plain version -----------------------------------
    # (label, B, H, H_kv, S, D, dtype, window, timing iters, as the decoder
    # calls it: transposed (B, S, heads, D) views)
    k5_cases = [
        ("served", 1, 16, 16, 128, 128, torch.bfloat16, None, 50, False),
        ("served f32", 1, 16, 16, 128, 128, torch.float32, None, 50, False),
        ("prefill", 1, 16, 16, 4096, 128, torch.bfloat16, None, 10, False),
        ("window", 1, 16, 16, 2048, 128, torch.float32, 512, 10, False),
        ("ragged", 2, 4, 4, 100, 64, torch.float32, None, 50, False),
        ("served GQA", 1, 16, 8, 128, 128, torch.bfloat16, None, 50, True),
        ("prefill GQA", 1, 16, 8, 4096, 128, torch.bfloat16, None, 10,
         True),
        # qwen2.5-14b's and llama4-scout's group of 5 at a decision's length
        ("GQA 5", 1, 40, 8, 128, 128, torch.bfloat16, None, 50, True),
        # long_500k's prefill core: Qwen3-0.6B windowed at 4,096
        ("long window", 1, 16, 8, 8192, 128, torch.bfloat16, 4096, 10,
         True),
    ]
    k5_rows = {}
    for idx, (label, B, H, H_kv, S, D, dt, win, iters,
              views) in enumerate(k5_cases):
        heads = (H, H_kv, H_kv)
        if views:
            q, k, v = (randn((B, S, n, D), 500 + 3 * idx + i).to(dt)
                       .transpose(1, 2) for i, n in enumerate(heads))
        else:
            q, k, v = (randn((B, n, S, D), 500 + 3 * idx + i).to(dt)
                       for i, n in enumerate(heads))
        n_rep = H // H_kv
        kr, vr = k.repeat_interleave(n_rep, 1), v.repeat_interleave(n_rep, 1)
        tc0, copies0 = flash_attention.tc_launches, flash_attention.copies
        got = flash_attention(q, k, v, causal=True, sliding_window=win)
        want = attention_ref(q.float(), kr.float(), vr.float(), causal=True,
                             sliding_window=win)
        again = flash_attention(q, k, v, causal=True, sliding_window=win)
        torch.cuda.synchronize()
        tc = dt == torch.bfloat16
        check(flash_attention.tc_launches - tc0 == 2 * tc
              and flash_attention.copies == copies0,
              f"K5 {label}: {flash_attention.tc_launches - tc0} tensor-core "
              f"launches of 2 (expected {2 * tc}), "
              f"{flash_attention.copies - copies0} copies (expected 0)")
        name = str(dt).removeprefix("torch.")
        tol = ATTN_TOL[name]
        check(got.dtype == dt and got.shape == q.shape
              and torch.isfinite(got).all(),
              f"K5 {label}: bad output {got.dtype} {tuple(got.shape)}")
        err = (got.float() - want).abs().max().item()
        check(torch.allclose(got.float(), want, atol=tol, rtol=tol),
              f"K5 {label}: differs from plain by {err} (tol {tol})")
        check(torch.equal(got, again),
              f"K5 {label}: two runs differ (must repeat bit for bit)")
        window_rel = None
        if win is not None and S >= 2 * win:
            # the rows whose window is full average ``win`` values each,
            # far below ATTN_TOL in size: held together, relative to their
            # size (K5_WINDOW_RTOL; a dropped 128-key tile moves them by
            # over 5x that, which the plain version at a window 128 keys
            # shorter shows here)
            window_rel = rel_rows(got, want, win)
            short = rel_rows(attention_ref(q.float(), kr.float(), vr.float(),
                                           causal=True,
                                           sliding_window=win - 128),
                             want, win)
            check(window_rel <= K5_WINDOW_RTOL < short / 5,
                  f"K5 {label}: the full-window rows {window_rel:.3g} of "
                  f"their size from plain (limit {K5_WINDOW_RTOL}); a window "
                  f"128 keys shorter {short:.3g}")
        # five event readings (a mean over ``iters`` calls each); the
        # median is the row's time, as K1's rows take it
        ms_reps = [cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                                   sliding_window=win),
                           iters=iters) for _ in range(5)]
        ms = median(ms_reps)
        plain_ms = cuda_ms(lambda: attention_ref(
            q, k.repeat_interleave(n_rep, 1), v.repeat_interleave(n_rep, 1),
            causal=True, sliding_window=win), iters=iters)
        if win is None:
            lib_mask = None
        else:
            pos = torch.arange(S, device=dev)
            lib_mask = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - win))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask, is_causal=lib_mask is None,
            enable_gqa=n_rep > 1), iters=iters)
        dev_us = kernel_device_us(lambda: flash_attention(
            q, k, v, causal=True, sliding_window=win), "flash_kernel",
            calls=iters)
        dev_us = dev_us and dev_us[0]
        flops = 4 * D * attention_pairs(S, win) * B * H
        b_ms, b_by = bound(nbytes(q, k, v, got), flops,
                           PEAK_BF16_FLOP_S if dt == torch.bfloat16
                           else PEAK_FP32_FLOP_S)
        t_ms = ms if dev_us is None else dev_us / 1e3
        print(f"K5 flash_attention {label} ({B},{H}/{H_kv} heads,{S},{D}) "
              f"{name} window {win}"
              + (" as (B,S,H,D) views" if views else "")
              + f", {'tensor' if tc else 'CUDA'}-core route: max_abs_err "
              f"{err:.3g} (tol {tol}, vs plain in f32), repeats bit for bit; "
              f"kernel {ms:.4f} ms (device "
              + ("not measured" if dev_us is None else f"{dev_us:.2f} us")
              + " a launch, traced; median of "
              + "/".join(f"{t:.4f}" for t in ms_reps)
              + f"), plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (scaled_dot_product_attention), bound "
              f"{b_ms:.5f} ms ({b_by}, {flops / 1e9:.4g} GFLOP); "
              f"{flops / t_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * b_ms / t_ms:.2f}% of the bound"
              + ("" if window_rel is None else
                 f"; the full-window rows {window_rel:.3g} of their size "
                 f"from plain (limit {K5_WINDOW_RTOL}), a window 128 keys "
                 f"shorter {short:.3g}"))
        if label == "served GQA":   # host-bound: the wrapper's host time
            k5_host = host_us(lambda: flash_attention(
                q, k, v, causal=True, sliding_window=win))
            lib_host = host_us(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            print(f"K5 {label}: {k5_host:.2f} us of host time a call, "
                  f"scaled_dot_product_attention {lib_host:.2f} us")
        k5_rows[label] = dict(max_abs_err=err, ms=ms, ms_reps=ms_reps,
                              device_us=dev_us,
                              plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_ms,
                              tflops=flops / t_ms / 1e9,
                              bound_share=b_ms / t_ms, shape=[B, H, S, D],
                              kv_heads=H_kv, dtype=name, window=win,
                              views=views, tensor_cores=tc,
                              window_rows_rel_err=window_rel)
        del q, k, v, kr, vr, got, want, again

    # ---- 9. the LM split path at Qwen3-0.6B's full width -------------------
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn.module import tree_map
    from repro_torch.serving.client import EdgeClient
    from repro_torch.serving.server import PolicyServer

    t0 = time.perf_counter()
    (lm_cfg, edge_fn, server_fn, mono_fn, _, wire_lm,
     raw_lm) = serve_cli.build_split("qwen3-0.6b", reduced=False,
                                     edge_segments=1, codec_name="uint8",
                                     batch=1, seq=128)
    build_s = time.perf_counter() - t0
    check(lm_cfg.n_layers == 28 and lm_cfg.d_model == 1024
          and lm_cfg.dtype == "bfloat16", f"not full width: {lm_cfg}")
    tokens = torch.randint(3, lm_cfg.vocab, (1, 128), generator=gen(13)) \
        .to(dev, torch.int32)
    reset_counts()
    payload = edge_fn(tokens)
    logits = server_fn(payload)
    torch.cuda.synchronize()
    lm_launches = flash_attention.launches
    lm_tc, lm_copies = flash_attention.tc_launches, flash_attention.copies
    check(counts() == (0, 0, 0, 0, 28), f"one split decision launched "
          f"K1..K5 {counts()} times; expected (0, 0, 0, 0, 28): 1 edge "
          f"layer + 27 server layers")
    check(lm_tc == 28 and lm_copies == 0, f"the decision's K5 launches: "
          f"{lm_tc} of 28 on the tensor cores, {lm_copies} input copies "
          f"(expected 28 and 0)")
    check(logits.shape == (1, 128, 151936) and logits.dtype == torch.bfloat16
          and torch.isfinite(logits.float()).all(),
          f"bad logits {logits.dtype} {tuple(logits.shape)}")
    check(payload["data"].dtype == torch.uint8 and wire_lm == 131080
          and raw_lm == 512, f"payload {payload['data'].dtype}, wire "
          f"{wire_lm} B, raw {raw_lm} B")
    reset_counts()
    mono = mono_fn(tokens)
    torch.cuda.synchronize()
    check(counts() == (0, 0, 0, 0, 28), f"the monolith launched K1..K5 "
          f"{counts()} times; expected (0, 0, 0, 0, 28)")
    top1 = (logits.argmax(-1) == mono.argmax(-1)).float().mean().item()
    edge_s = EdgeClient(encode_fn=edge_fn, wire_bytes=wire_lm) \
        .measure(tokens)
    split_s = PolicyServer(serve_fn=server_fn).measure(payload)
    mono_s = PolicyServer(serve_fn=mono_fn).measure(tokens)
    mono_ev_ms = cuda_ms(lambda: mono_fn(tokens), iters=5, warmup=1)
    print(f"LM split qwen3-0.6b full width (28 layers, d 1024, 16/8 heads, "
          f"head_dim 128, vocab 151936, bf16), 1x128 tokens, uint8 codec: "
          f"built in {build_s:.2f} s; one decision (edge + server) launched "
          f"K5 {lm_launches} times ({lm_tc} on the tensor cores, "
          f"{lm_copies} input copies), the monolith 28; logits "
          f"{tuple(logits.shape)} {logits.dtype} finite; top-1 agreement "
          f"with the monolith {top1:.4f}")
    print(f"qwen3-0.6b split@1 codec=uint8: edge {edge_s * 1e3:.4f}ms "
          f"server {split_s * 1e3:.4f}ms monolith {mono_s * 1e3:.4f}ms wire "
          f"{wire_lm}B raw {raw_lm}B (host clock around synchronize); "
          f"monolith by CUDA events {mono_ev_ms:.4f} ms")
    for line in serve_cli.latency_table(edge_s, split_s, mono_s, wire_lm,
                                        raw_lm, [10.0, 25.0, 50.0, 100.0]):
        print(line)
    traced = profile_decision(lambda: server_fn(edge_fn(tokens)))
    if traced is not None:
        print(f"profiled kernels of one decision: {traced[0]} (2,632 and "
              f"2,633 in two traces of it when the decoder still repeated "
              f"and copied K5's inputs)")
    del edge_fn, server_fn, mono_fn, payload, logits, mono

    (_, edge32, server32, mono32, *_) = serve_cli.build_split(
        "qwen3-0.6b", reduced=False, edge_segments=1, codec_name="float32",
        batch=1, seq=128)
    split32 = server32(edge32(tokens))
    mono_ref = mono32(tokens)
    torch.cuda.synchronize()
    lm_err = (split32.float() - mono_ref.float()).abs().max().item()
    check(torch.allclose(split32.float(), mono_ref.float(),
                         atol=LM_SPLIT_TOL, rtol=LM_SPLIT_TOL),
          f"float32-codec split differs from the monolith by {lm_err}")
    print(f"LM split, float32 codec: vs monolith max_abs_err {lm_err:.3g} "
          f"(tol {LM_SPLIT_TOL}), bitwise equal "
          f"{torch.equal(split32, mono_ref)}")
    del edge32, server32, mono32, split32, mono_ref

    # ---- 10. the card against the CPU, same parameters ---------------------
    lm_cpu_err = {}
    for label, cfg_c in (
            ("reduced", get_model("qwen3-0.6b", reduced=True)[0]),
            ("full width", dataclasses.replace(
                get_config("qwen3-0.6b"), n_layers=2, n_pattern=2,
                dtype="float32"))):
        model_c = DecoderModel(cfg_c)
        p_cpu = model_c.init(gen(21), device="cpu")
        p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
        tok = torch.randint(3, cfg_c.vocab, (1, 128), generator=gen(22))
        with torch.inference_mode():
            want, _ = model_c.forward(p_cpu, tok)
            reset_counts()
            got, _ = model_c.forward(p_gpu, tok.to(dev))
            torch.cuda.synchronize()
        check(counts() == (0, 0, 0, 0, cfg_c.n_layers),
              f"{label}: the card's forward launched K1..K5 {counts()}")
        err = (got.cpu() - want).abs().max().item()
        tol = LM_CPU_TOL[label]
        check(torch.allclose(got.cpu(), want, atol=tol, rtol=tol),
              f"{label} qwen3 f32: card differs from CPU by {err} (tol "
              f"{tol})")
        lm_cpu_err[label] = err
        print(f"LM card vs CPU, {label} qwen3 f32 ({cfg_c.n_layers} layers, "
              f"d {cfg_c.d_model}, {cfg_c.n_heads}/{cfg_c.n_kv_heads} heads, "
              f"head_dim {cfg_c.head_dim}) at (1,128): K5 launches "
              f"{cfg_c.n_layers}, logits max_abs_err {err:.3g} (tol {tol})")
        del p_cpu, p_gpu

    # ---- 11. the CLI, reduced as its flag forces ---------------------------
    check(serve_cli.main(["--bandwidths", "10,100"]) == 0,
          "python -m repro_torch.launch.serve failed")
    print(f"peak device memory {torch.cuda.max_memory_allocated()} B")

    # ---- 12. the paper's latency path on the card --------------------------
    # Table 5 (decision latency under bandwidth shaping), Table 6 (clients
    # a server sustains, FIFO against micro-batching, and the fleet), the
    # break-even bandwidth and one seeded scenario, all on the tuned
    # manifest's stage times measured here.  cuDNN's TF32 stays off (phase
    # 1): the server-only baseline's convs are fp32.
    from repro_torch.benchmarks import (break_even, decision_latency,
                                        scalability)
    from repro_torch.serving.scenario import get_scenario

    t_lat = time.perf_counter()
    # the kernel each backend's edge encode launches (a one-frame request
    # on fused+stream falls through to K1's plain launch)
    edge_kernel = {"fused": miniconv_encoder, "fused+head": miniconv_encoder,
                   "fused+stream": miniconv_encoder,
                   "reference": miniconv_pass,
                   "grouped": miniconv_layer_grouped}
    lat_cfg = dataclasses.replace(tuned_cfg, n_servers=4,
                                  router="least_loaded")
    if tp.backend not in edge_kernel:
        print(f"latency path: the tuner picked {tp.backend}, which launches "
              f"no hand kernel on the edge; the path runs on fused (K1)")
        lat_cfg = dataclasses.replace(lat_cfg, backend="fused", tuning=None)
    setup = decision_latency.build(config=lat_cfg, device="cuda")
    lat_backend = setup.deployment.backend.name
    lat_kernel = edge_kernel[lat_backend]
    check(setup.wire_bytes == 492 and setup.frame_bytes == 84 * 84 * 12,
          f"latency path: wire {setup.wire_bytes} B, frame "
          f"{setup.frame_bytes} B")
    reset_counts()
    rows5 = decision_latency.run((10, 25, 50, 100), n_decisions=1000,
                                 setup=setup)
    torch.cuda.synchronize()
    lat_counts = counts()
    lat_launches = lat_kernel.launches
    check(lat_launches > 0, f"Table 5 on {lat_backend} launched K1..K5 "
          f"{lat_counts}: its edge kernel ran no time")
    r10 = rows5[0]
    check(r10["mbps"] == 10 and r10["split_ms"] < r10["server_only_ms"],
          f"at 10 Mb/s split {r10['split_ms']} ms is not below server-only "
          f"{r10['server_only_ms']} ms")
    print(f"latency Table 5 on {lat_backend}: launches K1..K5 {lat_counts}; "
          f"split {r10['split_ms']:.4f} ms < server-only "
          f"{r10['server_only_ms']:.4f} ms at 10 Mb/s")

    times, model = decision_latency.measure_service_curve(setup, max_batch=8)
    queue = decision_latency.run_queue(n_clients=8, setup=setup, model=model)
    fifo_p95, batched_p95 = queue["fifo_p95_ms"], queue["batched_p95_ms"]
    check(batched_p95 <= 1.05 * fifo_p95 + 1e-9,
          f"smoke gate: batched p95 {batched_p95} ms > 1.05 x FIFO p95 "
          f"{fifo_p95} ms at N=8")
    check("fleet_p95_ms" in queue, "run_queue gave no fleet p95 for a "
          "4-server manifest")
    rows6, p95s = scalability.run(n_max=256, horizon_s=2.0, setup=setup,
                                  model=model)
    # the reference's --smoke sizes
    fleet_n_max, fleet_horizon = 2048, 2.0
    table = scalability.fleet_table(setup, model, mbps=1000.0,
                                    horizon_s=fleet_horizon,
                                    n_max=fleet_n_max, max_batch=8,
                                    max_wait_s=0.0)
    check(scalability.check_fleet_monotone(table, min_gain_at_4x=2.0,
                                           n_max=fleet_n_max),
          f"fleet table not monotone with >= 2x at 4 servers: {table}")

    rows_be = break_even.run()
    check(abs(rows_be[0]["pred"] - 50.4) < 0.05,
          f"paper break-even {rows_be[0]['pred']} Mb/s, expected 50.4")
    lat_manifest = ROOT / "build" / "latency_manifest.json"
    lat_manifest.write_text(lat_cfg.to_json(indent=2))
    be = break_even.run_manifest(str(lat_manifest), device="cuda")

    sc = get_scenario("wifi_markov")
    rep1, rep2 = (setup.deployment.scenario_sim(sc).report(sc.n_clients)
                  for _ in range(2))
    check(rep1.latencies.tobytes() == rep2.latencies.tobytes()
          and rep1.mode_idx.tobytes() == rep2.mode_idx.tobytes()
          and rep1.total_uplink_bytes == rep2.total_uplink_bytes
          and rep1.delivered_return == rep2.delivered_return,
          "wifi_markov: two runs of one seed differ")
    lat_s = time.perf_counter() - t_lat
    print(f"scenario wifi_markov (seed {sc.seed}, {sc.n_clients} clients, "
          f"{lat_cfg.n_servers} servers, {lat_cfg.router}): two runs "
          f"bitwise equal; {rep1.n_requests} requests, p95 "
          f"{rep1.p95_s * 1e3:.4f} ms, deadline hit rate "
          f"{rep1.deadline_hit_rate:.4f}, modes {rep1.mode_counts()}")
    latency_path = {
        "backend": lat_backend, "launches": list(lat_counts),
        "table5": rows5,
        "service_ms": {b: t * 1e3 for b, t in sorted(times.items())},
        "queue": queue, "table6": rows6,
        "table6_n_max": 256, "split_p95_ms": {n: list(v) for n, v in
                                               p95s.items()},
        "fleet": table, "fleet_n_max": fleet_n_max,
        "fleet_horizon_s": fleet_horizon, "fleet_mbps": 1000.0,
        "break_even_paper": rows_be, "break_even_manifest": be,
        "scenario": {"name": sc.name, "p95_ms": rep1.p95_s * 1e3,
                     "hit_rate": rep1.deadline_hit_rate,
                     "modes": rep1.mode_counts(), "bitwise_repeat": True},
        "seconds": lat_s}
    print(f"latency path: {lat_s:.2f} s")
    print(json.dumps({"latency_path": latency_path}, default=float))

    # ---- 13. the real fleet on the card ------------------------------------
    # Worker processes spawned from the latency path's manifest (tuned, 4
    # servers behind least_loaded), each with its own CUDA context on this
    # card and the TF32 switches of phase 1; phase 1 built the kernels, so
    # no worker runs nvcc.  (a) socket-served actions bitwise equal to
    # in-process serving, through every router and after a kill; (b) the
    # sim-to-real calibration at 1, 2 and 4 servers and its gate; (c) one
    # cell with shaped ingress; (d) Table 5's real-fleet row; (e) the edge
    # kernel sustained for 2,000 frames.
    from repro_torch.benchmarks import realfleet as rf_bench
    from repro_torch.benchmarks import sustained

    t_rf = time.perf_counter()
    reset_counts()
    seen = deploy_cli._real_fleet_check(lat_cfg, n_requests=8,
                                        device="cuda")
    torch.cuda.synchronize()
    rf_a_launches = lat_kernel.launches
    check(rf_a_launches > 0, f"real fleet (a): the edge encode launched "
          f"K1..K5 {counts()}")
    rerouted = seen["per_server_after_kill"]
    check(seen["bitwise"] and seen["leaked"] == []
          and min(seen["per_server"]) > 0 and sum(rerouted[1:]) == 8,
          f"real fleet (a): {seen}")
    rf_a_s = time.perf_counter() - t_rf
    print(f"real fleet (a): {lat_cfg.n_servers} workers on the card, 8 "
          f"requests (payloads by {lat_kernel.__name__}, {rf_a_launches} "
          f"launches) through {', '.join(seen['routers'])}: bitwise equal "
          f"to in-process serving, per-server {seen['per_server']}; worker "
          f"0 killed, re-routed {rerouted}, bitwise; 0 leaked; "
          f"{rf_a_s:.2f} s")

    t0 = time.perf_counter()
    reset_counts()
    rows_b = rf_bench.calibrate(lat_cfg, n_servers_list=(1, 2, 4),
                                n_clients=4, rate_hz=20.0, duration_s=1.5,
                                device="cuda")
    check(rf_bench.smoke_gate(rows_b), "real fleet (b): the calibration "
          "gate failed (3x + 25 ms, no failure, no leak)")
    rows_c = rf_bench.calibrate(lat_cfg, n_servers_list=(1,),
                                routers=("round_robin",), n_clients=4,
                                rate_hz=20.0, duration_s=1.5,
                                shaped_mbps=10.0, device="cuda")
    check(all(r["n_failures"] == 0 and r["leaked_workers"] == 0
              for r in rows_c), f"real fleet (c): {rows_c}")
    row_d = decision_latency.run_real_fleet(setup, n_clients=8,
                                            rate_hz=10.0)
    check(row_d["real_n_failures"] == 0
          and row_d["real_leaked_workers"] == 0, f"real fleet (d): {row_d}")
    torch.cuda.synchronize()
    rf_bcd_launches = lat_kernel.launches
    rf_bcd_s = time.perf_counter() - t0
    print(f"real fleet (b)-(d): {rf_bcd_s:.2f} s, {lat_kernel.__name__} "
          f"launches {rf_bcd_launches}")

    per_frame = {miniconv_encoder: 1, miniconv_layer_grouped: 3,
                 miniconv_pass: 9}[lat_kernel]
    t0 = time.perf_counter()
    reset_counts()
    sus = sustained.run(manifest=str(lat_manifest), n_frames=2000,
                        device="cuda")
    torch.cuda.synchronize()
    rf_e_launches = lat_kernel.launches
    want_e = (2000 + sustained.WARMUP) * per_frame
    check(rf_e_launches == want_e, f"sustained: {lat_kernel.__name__} "
          f"launched {rf_e_launches} times, expected {want_e} (frames plus "
          f"warm-up)")
    (sus_name, sus_row), = sus.items()
    rf_e_s = time.perf_counter() - t0
    print(f"sustained ({sus_name}): 2000 frames, {lat_kernel.__name__} "
          f"launches {rf_e_launches} = frames + warm-up; {rf_e_s:.2f} s")
    rf_s = time.perf_counter() - t_rf
    real_fleet = {
        "backend": lat_backend, "kernel": lat_kernel.__name__,
        "check": seen, "launches": {"a": rf_a_launches,
                                    "b_to_d": rf_bcd_launches,
                                    "e": rf_e_launches},
        "calibration": rows_b, "shaped": rows_c, "table5_row": row_d,
        "sustained": dict(sus_row, name=sus_name),
        "seconds": {"a": rf_a_s, "b_to_d": rf_bcd_s, "e": rf_e_s,
                    "phase": rf_s}}
    print(f"real fleet: {rf_s:.2f} s")
    print(json.dumps({"real_fleet": real_fleet}, default=float))
    del setup

    # ---- 14. the RL training stack on the card ------------------------------
    # cuDNN's and cuBLAS's TF32 stay off (phase 1): the card is held against
    # the CPU in full fp32, and the trained policies train that way.
    training, train_k1 = training_phase(dev, gen, miniconv_encoder,
                                        reset_counts)
    print(json.dumps({"training": training}, default=float))

    # ---- 15. populations on the card ----------------------------------------
    # The gates run in a deterministic child process (it resets and reads
    # K1's count around its own serving path); TF32 stays off in both.
    population = population_phase(dev, card)
    print(json.dumps({"population": population}, default=float))

    # the dry-run children of phase 19 run beside phases 16 to 18; none
    # outlives this process
    dryrun_children = start_dryrun(ROOT / "chiprun_out" / "phase19")
    atexit.register(lambda: [p.kill() for p in dryrun_children[0]
                             if p.poll() is None])

    # ---- 16. the LM decode path and training at full width -----------------
    # Decoding and training take the eager attention branches (decode's
    # scores over the cache; a training step needs autograd, which K5
    # lacks); K5 runs the forward the decode is held against.
    lm = lm_phase(dev, gen, reset_counts, counts)
    print(json.dumps({"lm": lm}, default=float))

    # ---- 17. the MoE, SSM and RG-LRU families at full width -----------------
    # Each model is freed before the next; K5 runs the MoE's 24 attention
    # cores a decision, and no core of the other two.
    families = families_phase(dev, gen, reset_counts, counts)
    print(json.dumps({"families": families}, default=float))

    # ---- 18. Whisper's encoder-decoder and llava's prefill at full width ---
    # K5 runs Whisper's non-causal encoder and its ragged 448-position
    # decoder (24 launches each) and llava's 3,008-token prefill (32).
    whisper = whisper_phase(dev, gen, reset_counts, counts)
    print(json.dumps({"whisper": whisper}, default=float))

    # ---- 19. the sharded LM step and its dry-run ---------------------------
    # K5 runs the sharded prefill's 28 cores through local_map.
    sharded = sharded_phase(dev, gen, reset_counts, counts, card,
                            dryrun_children)
    print(json.dumps({"sharded": sharded}, default=float))

    # ---- 20. the port's static analysis ------------------------------------
    analysis = lint_phase(card, lint)
    print(json.dumps({"analysis": analysis}, default=float))

    # ---- 21. the dense decoders at full width and long_500k's decode -------
    # K5 runs every attention core of each split decision (32, 48, 32 and
    # the scout's 2) and long_500k's 28 windowed prefill cores.
    dense = dense_phase(dev, gen, reset_counts, counts, card)
    print(json.dumps({"dense": dense}, default=float))

    # ---- 22. K7, K5's scale and K8 at granite-4.0-h's shapes ---------------
    granite = granite_phase(dev, card)
    print(json.dumps({"granite": granite}, default=float))

    # ---- 23. results -------------------------------------------------------
    k1 = k1_rows["served edge"]
    def layer_row(rows, dev_us):
        """The served frame's row, with the 400x400 and batch-8 times."""
        row = dict(rows["served edge"], device_us=dev_us)
        for pre, label in (("400x400", "400x400"), ("batch8", "batch")):
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "max_abs_err"):
                row[f"{pre}_{key}"] = rows[label][key]
        return row

    k2 = layer_row(k2_rows, k2_us)
    k3 = layer_row(k3_rows, k3_us)
    k4 = dict(max_abs_err=errB, ms=k4_ms, plain_ms=plainB_ms,
              bound_ms=bB_ms, bound_by=bB_by, library_ms=libB_ms,
              shape=[64, 400, 400, 4], head=hwB.shape[1], chunk_b=chunkB,
              k1_ms=k1_ms, device_ms=None if k4_us is None else k4_us / 1e3)
    kernels = [
        dict(name="miniconv_encoder", route="cuda",
             source="src/repro_torch/kernels/csrc/miniconv_encoder.cu",
             replaces="src/repro/kernels/miniconv_pass.py:267",
             launches=fused_launches, **k1,
             batch_head={k: k1_rows["batch+head"][k] for k in (
                 "ms", "device_us", "plain_ms", "library_ms", "bound_ms",
                 "max_abs_err", "shape", "head", "tiles")}),
        dict(name="miniconv_pass", route="cuda",
             source="src/repro_torch/kernels/csrc/miniconv_layer.cu",
             replaces="src/repro/kernels/miniconv_pass.py:91",
             launches=ref_launches, copies=ref_copies, **k2),
        dict(name="miniconv_layer_grouped", route="cuda",
             source="src/repro_torch/kernels/csrc/miniconv_layer.cu",
             replaces="src/repro/kernels/miniconv_pass.py:164",
             launches=grouped_launches, **k3),
        dict(name="miniconv_encoder_stream", route="cuda",
             source="src/repro_torch/kernels/csrc/miniconv_encoder.cu",
             replaces="src/repro/kernels/miniconv_pass.py:575",
             launches=stream_launches, **k4),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:26",
             launches=lm_launches, tc_launches=lm_tc, copies=lm_copies,
             hgmma=hgmma, host_us=k5_host, library_host_us=lib_host,
             **k5_rows["served GQA"],
             decision_device_us=None if traced is None else traced[1],
             **{f"{pre}_{key}": k5_rows[label][key]
                for pre, label in (("prefill", "prefill GQA"),
                                   ("served_mha", "served"),
                                   ("prefill_mha", "prefill"))
                for key in ("ms", "ms_reps", "device_us", "library_ms",
                            "bound_ms", "tflops")}),
        dict(name="moe_grouped", route="cuda",
             source="src/repro_torch/kernels/csrc/moe_grouped.cu",
             replaces=None, **granite["k7"]),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces=None, **granite["k8"]),
        dict(name="moe_combine", route="cuda",
             source="src/repro_torch/kernels/csrc/moe_combine.cu",
             replaces=None, **granite["k9"]),
    ]
    kernels[4]["lm_decode_oracle_launches"] = lm["decode"][
        "oracle_k5_launches"]
    kernels[4]["moe_decision_launches"] = families["k5_moe"][
        "decision_launches"]
    for key in ("ms", "ms_reps", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err", "shape", "kv_heads", "views"):
        kernels[4][f"moe_{key}"] = families["k5_moe"][key]
    kernels[4]["whisper_encode_launches"] = \
        whisper["model"]["encode_launches"][4]
    kernels[4]["whisper_decoder_launches"] = \
        whisper["model"]["decoder_launches"][4]
    kernels[4]["llava_prefill_launches"] = whisper["llava"]["launches"][4]
    kernels[4]["sharded_prefill_launches"] = \
        sharded["steps"]["prefill_32k"]["k5_launches"]
    for key in ("ms", "ms_reps", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "shape", "kv_heads"):
        kernels[4][f"prefill_32k_{key}"] = sharded["k5_32k"][key]
    for arch, row in list(dense["configs"].items()) + [(SCOUT,
                                                         dense["scout"])]:
        kernels[4][f"{arch}_decision_launches"] = row["decision"][
            "launches"][4]
    kernels[4]["long_500k_prefill_launches"] = \
        dense["long_500k"]["prefill_launches"][4]
    kernels[4]["granite_decision_launches"] = granite["k5"]["served_launches"]
    for pre, label in (("gqa5", "GQA 5"), ("long_window", "long window")):
        for key in ("ms", "ms_reps", "device_us", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "max_abs_err", "shape",
                    "kv_heads", "window", "window_rows_rel_err"):
            kernels[4][f"{pre}_{key}"] = k5_rows[label][key]
    for pre, label in (("whisper_enc", "whisper encoder"),
                       ("whisper_enc_f32", "whisper encoder f32"),
                       ("whisper_dec", "whisper decoder"),
                       ("whisper_dec_f32", "whisper decoder f32"),
                       ("llava", "llava prefill")):
        for key in ("ms", "ms_reps", "device_us", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "max_abs_err", "shape",
                    "causal"):
            kernels[4][f"{pre}_{key}"] = whisper["k5"][label][key]
    kernels[0]["training_serve_launches"] = train_k1
    kernels[0]["population_serve_launches"] = \
        population["gates"]["serve"]["k1_launches"]
    for label, key in (("train served", "train_served"),
                       ("train batch+head", "train_batch_head")):
        kernels[0][key] = {k: k1_rows[label][k] for k in (
            "ms", "ms_reps", "device_us", "plain_ms", "plain_ms_reps",
            "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "shape", "head", "tiles")}
    for k in kernels:
        if k["name"] == lat_kernel.__name__:
            k["latency_path_launches"] = lat_launches
            k["real_fleet_launches"] = (rf_a_launches + rf_bcd_launches
                                        + rf_e_launches)
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel was launched no time on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--population-gates"]:
        sys.exit(population_gates())
    if sys.argv[1:] == ["--granite"]:
        sys.exit(granite_main())
    if sys.argv[1:2] == ["--sharded-dryrun"] and len(sys.argv) == 3:
        sys.exit(sharded_dryrun(sys.argv[2]))
    sys.exit(main())
