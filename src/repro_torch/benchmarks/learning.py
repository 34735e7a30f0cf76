"""Paper Tables 2-4: learning performance per (task, algorithm) with the
three encoder conditions (MiniConv K=4, K=16, Full-CNN), with the
learning throughput (env-steps/s) of each condition (port of the
reference's ``benchmarks/learning.py``).

The environments are simplified (the reference's DESIGN.md §4), so
absolute returns are not comparable to the paper; the benchmark
reproduces the comparison's structure — within-task Best/Mean/Final per
encoder — and the tooling.  Default is smoke scale; pass ``--full`` for
long runs.

Throughput modes
----------------
``--smoke``   one encoder per task (all three algorithms), gated on finite
              Best/Mean/Final, at least one completed episode and nonzero
              steps/s a condition.
``--compare`` also measures the off-policy engine against the
              pre-refactor per-step loop (one env, the host numpy replay
              buffer, one eager env step and one act a step —
              reimplemented here as the throughput baseline) and reports
              the speedup.  Both sides exclude their first calls (warm
              steps/s).

    python -m repro_torch.benchmarks.learning --smoke [--device cpu]

The document goes to ``build/learning.json`` (never the reference's
committed ``BENCH_learning.json``).
"""
from __future__ import annotations

import argparse
import json
import platform
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import perfstamp
from repro_torch.device import resolve_device
from repro_torch.envs import make_pixel_env
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.rl.agent import make_agent
from repro_torch.rl.buffers import ReplayBuffer
from repro_torch.rl.rollout import make_engine, to_host
from repro_torch.rl.train import TASK_ALGO, _pipeline_encoder, train
from repro_torch.serving.server import _block

ENCODERS = ("miniconv4", "miniconv16", "full_cnn")
TASKS = ("walker", "hopper", "pendulum")     # PPO / SAC / DDPG per paper
ARTIFACT = str(BUILD_DIR.parent / "learning.json")


def _smoke_cfgs():
    """Bounded algorithm configs for the smoke gate: the same algorithms
    and engines at a smaller scale.  learning_starts is pulled below the
    256-step smoke budget so the gate runs interleaved SAC/DDPG gradient
    updates, not just random-action warmup (batch 32 keeps them cheap).

    DDPG runs ONE env: pendulum episodes are a fixed 200 steps, so at
    n_envs=4 a 256-step budget is 64 steps per env and every episode is
    truncated (the episodes_completed=0 condition the gate rejects); one
    env completes a full episode inside the budget."""
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.ppo import PPOConfig
    from repro_torch.rl.sac import SACConfig
    return {"ppo": PPOConfig(n_envs=4, n_steps=32, n_epochs=2,
                             n_minibatches=4),
            "sac": SACConfig(n_envs=4, learning_starts=192, batch_size=32),
            "ddpg": DDPGConfig(n_envs=1, learning_starts=192,
                               batch_size=32)}


def run(*, total_steps: int = 512, tasks=TASKS, encoders=ENCODERS,
        seed: int = 0, verbose: bool = False, cfgs=None, device=None):
    rows = []
    for task in tasks:
        for enc in encoders:
            cfg = (cfgs or {}).get(TASK_ALGO[task])
            res = train(task, enc, total_steps=total_steps, seed=seed,
                        verbose=verbose, cfg=cfg, device=device)
            rows.append(res)
            s = res.summary()
            steady = s["steady_steps_per_sec"]
            print(f"  {task:<10} {res.algo:<5} {enc:<11} "
                  f"best={res.best:8.1f} final={res.final:8.1f} "
                  f"mean={res.mean:8.1f} episodes={s['episodes']} "
                  f"({s['episodes_truncated']} truncated) "
                  f"steps/s={res.steps_per_sec:7.1f} "
                  f"compile_s={res.compile_s:6.2f} "
                  f"steady/s={steady if steady is None else round(steady, 1)}")
    return rows


# ---------------------------------------------------------------------------
# Throughput: the engine (warm) vs the legacy per-step loop
# ---------------------------------------------------------------------------

def measure_engine_throughput(task: str, encoder_name: str, *,
                              total_steps: int, seed: int = 0,
                              n_envs=None, device=None) -> float:
    """Warm env-steps/s of the engine.

    Runs the training plan once to pay every phase shape's first call,
    then re-initialises and times a second pass.  Init (params, env
    resets, ring allocation) happens outside the timed window: the legacy
    baseline's timer also starts after its setup, so the two sides time
    the same thing, the loop.
    """
    dev = resolve_device(device)
    algo = TASK_ALGO[task]
    env = make_pixel_env(task, train=True)
    encoder = _pipeline_encoder(encoder_name, env.obs_shape[-1], device=dev)
    agent = make_agent(algo, encoder, env.action_dim, n_envs=n_envs,
                       device=dev)
    engine = make_engine(env, agent, total_steps, device=dev)

    def one_pass(seed):
        carry = engine.init(seed)
        _block()
        t0 = time.perf_counter()
        steps = 0
        for phase in engine.plan():
            carry, rewards, dones, _ = engine.run(carry, phase)
            steps += int(to_host(rewards, dones)[0].size)
        _block()
        return steps / (time.perf_counter() - t0)

    one_pass(seed)                      # first calls
    return one_pass(seed + 1)           # timed, warm


def measure_legacy_throughput(task: str, encoder_name: str, *,
                              total_steps: int, seed: int = 0,
                              device=None) -> float:
    """env-steps/s of the PRE-REFACTOR off-policy loop (the baseline).

    As the seed trainer ran it: ONE env, one eager env step and one act a
    step, the host-side numpy replay buffer (every transition copied to
    the host and every minibatch back), a fresh
    ``np.random.default_rng(seed + t)`` per warmup step, and one gradient
    update a step once past ``learning_starts``.  Every piece is warmed
    before the timed loop, so the comparison against the engine is warm
    against warm.
    """
    dev = resolve_device(device)
    algo = TASK_ALGO[task]
    if algo == "ppo":
        raise ValueError("legacy baseline is the OFF-policy per-step loop")
    env = make_pixel_env(task, train=True)
    encoder = _pipeline_encoder(encoder_name, env.obs_shape[-1], device=dev)
    agent = make_agent(algo, encoder, env.action_dim, device=dev)
    cfg = agent.cfg

    def host(x):
        return x.cpu().numpy()

    def device_batch(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    state = agent.init(torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    env_state, obs = env.reset_batch(
        torch.Generator(device=dev).manual_seed(seed + 2), 1)

    # warm every piece so the timed loop runs warm
    buf = ReplayBuffer(cfg.buffer_size, env.obs_shape, env.action_dim, seed)
    a, _ = agent.act(state.params, obs, gen)
    env.step_batch(env_state, a)
    buf.add_batch(host(obs), host(a), np.zeros(1, np.float32), host(obs),
                  np.zeros(1, bool))
    if total_steps > cfg.learning_starts:
        agent.target_update(agent.update(
            state, device_batch(buf.sample(cfg.batch_size)), gen)[0])
    _block()
    buf = ReplayBuffer(cfg.buffer_size, env.obs_shape, env.action_dim, seed)

    t0 = time.perf_counter()
    for t in range(total_steps):
        if t < cfg.learning_starts:
            action = torch.from_numpy(np.random.default_rng(seed + t).uniform(
                -1, 1, (1, env.action_dim)).astype(np.float32)).to(dev)
        else:
            action, _ = agent.act(state.params, obs, gen)
        env_state, next_obs, reward, done = env.step_batch(env_state, action)
        buf.add_batch(host(obs), host(action), host(reward), host(next_obs),
                      host(done))
        obs = next_obs
        if t >= cfg.learning_starts and len(buf) >= cfg.batch_size:
            state, _ = agent.update(
                state, device_batch(buf.sample(cfg.batch_size)), gen)
            state = agent.target_update(state)
    _block()
    return total_steps / (time.perf_counter() - t0)


def compare_offpolicy(task: str = "pendulum", encoder: str = "miniconv4", *,
                      total_steps: int = 256, seed: int = 0,
                      n_envs: int = 8, reps: int = 3, device=None) -> dict:
    """The engine (vectorised, on the device) vs the legacy loop (one env —
    it HAS no n_envs; that asymmetry is the point of the refactor).

    Measured in the COLLECTION regime (total_steps below learning_starts,
    so neither side runs gradient updates): the update math is the same
    on both sides, so collection isolates what the refactor changed —
    per-step host dispatch and transfers, host RNG construction, numpy
    replay traffic — from compute the two loops share.  The row carries
    ``regime: "collection"``.

    The two measurements interleave ``reps`` times and the BEST of each
    side is compared (timeit-style), so a throttling window on a shared
    host biases neither side.
    """
    engine, legacy = [], []
    for _ in range(reps):
        engine.append(measure_engine_throughput(
            task, encoder, total_steps=total_steps, seed=seed,
            n_envs=n_envs, device=device))
        legacy.append(measure_legacy_throughput(
            task, encoder, total_steps=total_steps, seed=seed,
            device=device))
    engine_sps = float(np.max(engine))
    legacy_sps = float(np.max(legacy))
    row = {"task": task, "algo": TASK_ALGO[task], "encoder": encoder,
           "total_steps": total_steps, "n_envs": n_envs,
           "regime": "collection",
           "engine_steps_per_sec": engine_sps,
           "legacy_steps_per_sec": legacy_sps,
           "engine_reps": engine, "legacy_reps": legacy,
           "speedup": engine_sps / legacy_sps}
    print(f"  off-policy COLLECTION throughput [{task}/{encoder}]: "
          f"engine {engine_sps:.1f} (n_envs={n_envs}) vs legacy per-step "
          f"loop {legacy_sps:.1f} env-steps/s -> {row['speedup']:.1f}x")
    return row


def write_bench(rows, *, total_steps: int, compare_row=None,
                path: str = ARTIFACT, device=None) -> dict:
    dev = resolve_device(device)
    doc = perfstamp.stamp({
        "benchmark": "learning",
        "host_detail": {"platform": platform.platform(),
                        "device": str(dev)},
        "total_steps": total_steps,
        "conditions": [r.summary() | {"wall_time_s": r.wall_time_s}
                       for r in rows],
    }, device=dev)
    if compare_row is not None:
        doc["offpolicy_throughput"] = compare_row
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(doc, indent=2))
    print(f"  wrote {path}")
    return doc


def check_smoke(doc: dict) -> None:
    """The learning gate: every condition finite with nonzero throughput,
    and at least one COMPLETED episode per condition — Best/Mean/Final
    must be real episodic statistics, not truncated-partial fallbacks."""
    for c in doc["conditions"]:
        name = f"{c['task']}/{c['encoder']}"
        for k in ("best", "final", "mean"):
            assert np.isfinite(c[k]), f"{name}: non-finite {k}={c[k]}"
        assert c["episodes"] >= 1, f"{name}: no episodes recorded"
        assert c["episodes_completed"] >= 1, \
            f"{name}: 0 completed episodes — stats fall back to " \
            "truncated partials (bound episode length or raise the budget)"
        assert c["steps_per_sec"] > 0, f"{name}: zero throughput"
        assert np.isfinite(c["compile_s"]) and c["compile_s"] >= 0, \
            f"{name}: bad compile_s={c['compile_s']}"
        steady = c["steady_steps_per_sec"]
        assert steady is None or steady > 0, \
            f"{name}: bad steady_steps_per_sec={steady}"
    thr = doc.get("offpolicy_throughput")
    if thr is not None:
        assert thr["engine_steps_per_sec"] > 0 \
            and thr["legacy_steps_per_sec"] > 0, "zero throughput measured"
    print(f"  smoke gate OK: {len(doc['conditions'])} conditions finite, "
          f"steps/sec > 0")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--full", action="store_true",
                    help="paper scale (200,000 steps a condition)")
    ap.add_argument("--tasks", default=",".join(TASKS))
    ap.add_argument("--encoders", default=",".join(ENCODERS))
    ap.add_argument("--smoke", action="store_true",
                    help="one encoder per task (all three algorithms) and "
                         "gate on finite returns + nonzero steps/sec")
    ap.add_argument("--compare", action="store_true",
                    help="also measure the off-policy engine vs the legacy "
                         "per-step loop (warm env-steps/sec)")
    ap.add_argument("--json", default=ARTIFACT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the port never falls back")
    args = ap.parse_args(argv)
    steps = 200_000 if args.full else args.steps
    encoders = ("miniconv4",) if args.smoke else \
        tuple(args.encoders.split(","))
    rows = run(total_steps=steps, tasks=args.tasks.split(","),
               encoders=encoders, cfgs=_smoke_cfgs() if args.smoke else None,
               device=args.device)
    compare_row = None
    if args.compare:
        compare_row = compare_offpolicy(total_steps=min(steps, 256),
                                        device=args.device)
    doc = write_bench(rows, total_steps=steps, compare_row=compare_row,
                      path=args.json, device=args.device)
    if args.smoke:
        check_smoke(doc)
    print("task,algo,encoder,best,final,mean,episodes,steps_per_sec")
    for r in rows:
        s = r.summary()
        print(f"{r.task},{r.algo},{r.encoder},{r.best:.1f},{r.final:.1f},"
              f"{r.mean:.1f},{s['episodes']},{r.steps_per_sec:.1f}")
    return doc


if __name__ == "__main__":
    main()
