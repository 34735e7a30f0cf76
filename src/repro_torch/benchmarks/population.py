"""Population-engine throughput: P members in one engine against running
the single-run engine P times, plus the correctness gates that make the
number trustworthy (port of the reference's ``benchmarks/population.py``).

What is measured
----------------
Aggregate env-steps/s (summed over members) for populations of P in {1,
4, 16} against the sequential baseline: the single-run engine built and
run P times.  Each side runs its plan twice, each pass after its own
init: the first pass pays the first calls of each phase shape, the
second runs warm.  The reference's population compiles its chunk once
for P members, and its speedup is that of the first passes, XLA compile
included.  The port compiles nothing: its first calls pay the
allocator's first allocations and cuDNN's algorithm search, once a
process, so P sequential runs in one process would not each pay what the
baseline's first pass pays.  ``speedup_vs_sequential`` is therefore that
of the warm passes; the first passes' (the reference's definition) is
reported beside it as ``first_pass_speedup_vs_sequential``.  What a
population saves here is launches: in ``"vmap"`` lanes one launch does
the work of P members, while ``"exact"`` lanes run the single-run bodies
one member after another and launch P times as much.  Both lane modes are
measured.  Rows are stamped via ``repro_torch.perfstamp`` and marked
``regime: "collection"``: the budget is all warmup, so every side runs
the same random-action loop (env steps, renders and ring inserts, no
update).

``--smoke`` gates:

* the ``vmap`` lanes' warm aggregate collection throughput at the
  largest P is at least 3x the sequential baseline's, and at least 1x at
  every P > 1 (the ``exact`` lanes are reported without a gate: they
  launch what the sequential runs launch);
* member 0 of a P=2 population (exact lanes, with gradient updates,
  tiny config) is BITWISE equal to ``repro_torch.rl.train.train`` at the
  same seed — on a GPU in deterministic mode
  (``torch.use_deterministic_algorithms``), since cuDNN's weight-gradient
  algorithms need not repeat bit for bit otherwise;
* the eval protocol is deterministic: bitwise replay at a fixed seed and
  a finite ``final_100_mean`` on a shortened episode window.

    python -m repro_torch.benchmarks.population --smoke [--device cpu]

The document goes to ``build/population.json`` (never the reference's
committed ``BENCH_population.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import perfstamp
from repro_torch.device import resolve_device
from repro_torch.envs import make_pixel_env
from repro_torch.kernels._build import BUILD_DIR
from repro_torch.nn.module import tree_leaves
from repro_torch.rl.agent import make_agent
from repro_torch.rl.ddpg import DDPGConfig
from repro_torch.rl.population import (LANE_MODES, PopulationSpec, evaluate,
                                       final_100_mean,
                                       make_population_engine,
                                       train_population)
from repro_torch.rl.rollout import make_engine, to_host
from repro_torch.rl.train import _pipeline_encoder, train
from repro_torch.serving.server import _block

TASK = "pendulum"
ENCODER = "miniconv4"
ARTIFACT = str(BUILD_DIR.parent / "population.json")
DEFAULT_POPS = (1, 4, 16)
SMOKE_SPEEDUP = 3.0       # vmap lanes at the largest P vs sequential


def _collection_cfg(total_steps: int, n_envs: int = 2) -> DDPGConfig:
    """learning_starts above the budget -> the whole run is random-action
    collection: population and sequential sides execute the identical
    warmup loop, so the comparison isolates what batching the members
    saves from learning compute."""
    return DDPGConfig(n_envs=n_envs, learning_starts=total_steps + n_envs,
                      buffer_size=max(total_steps * n_envs, n_envs),
                      batch_size=n_envs)


def _passes(engine, init_arg, next_arg) -> dict:
    """Two passes over ``engine``'s plan, each after its own ``init``
    (outside the window): the first pays the first calls, the second runs
    warm.  Env steps (every member) and seconds of each."""
    def one_pass(arg):
        carry = engine.init(arg)
        _block()
        t0 = time.perf_counter()
        steps = 0
        for phase in engine.plan():
            carry, rewards, dones, _ = engine.run(carry, phase)
            steps += int(to_host(rewards, dones)[0].size)
        _block()
        return steps, time.perf_counter() - t0

    steps, wall = one_pass(init_arg)
    _, steady = one_pass(next_arg)
    return {"steps": steps, "wall_s": wall, "steady_s": steady}


def measure_single(total_steps: int, *, seed: int = 0, n_envs: int = 2,
                   cfg=None, device=None) -> dict:
    """One FROM-SCRATCH single-run engine pass (fresh encoder pipeline,
    agent and engine, as every ``benchmarks.learning`` condition builds
    them) plus a warm second pass.  ``cfg`` defaults to the collection
    regime's."""
    dev = resolve_device(device)
    env = make_pixel_env(TASK, train=True)
    encoder = _pipeline_encoder(ENCODER, env.obs_shape[-1], device=dev)
    cfg = cfg or _collection_cfg(total_steps, n_envs)
    agent = make_agent("ddpg", encoder, env.action_dim, cfg=cfg, device=dev)
    engine = make_engine(env, agent, total_steps, device=dev)
    return _passes(engine, seed, seed + 1)


def measure_population(P: int, total_steps: int, *, seed: int = 0,
                       n_envs: int = 2, lane_mode: str = "exact", cfg=None,
                       device=None) -> dict:
    """One from-scratch population pass (P members in one engine) plus a
    warm second pass on the next P seeds."""
    dev = resolve_device(device)
    env = make_pixel_env(TASK, train=True)
    encoder = _pipeline_encoder(ENCODER, env.obs_shape[-1], device=dev)
    cfg = cfg or _collection_cfg(total_steps, n_envs)
    engine = make_population_engine(env, "ddpg", encoder, env.action_dim,
                                    cfg, {}, P, total_steps,
                                    lane_mode=lane_mode, device=dev)
    return _passes(engine, list(range(seed, seed + P)),
                   list(range(seed + P, seed + 2 * P)))


def run_grid(pops=DEFAULT_POPS, *, total_steps: int = 64, seed: int = 0,
             n_envs: int = 2, lane_modes=LANE_MODES, cfg=None,
             regime: str = "collection", device=None) -> list[dict]:
    """Rows: per lane mode and P, the population's aggregate throughput
    against the sequential baseline P x (one single run), warm passes and
    first passes."""
    base = measure_single(total_steps, seed=seed, n_envs=n_envs, cfg=cfg,
                          device=device)
    print(f"  baseline single run: {base['steps']} steps in "
          f"{base['wall_s']:.2f}s (steady pass {base['steady_s']:.2f}s)")
    rows = []
    for lane_mode in lane_modes:
        for P in pops:
            pop = measure_population(P, total_steps, seed=seed,
                                     n_envs=n_envs, lane_mode=lane_mode,
                                     cfg=cfg, device=device)
            seq_wall = P * base["wall_s"]             # P from-scratch runs
            agg_sps = pop["steps"] / pop["wall_s"]
            seq_sps = (P * base["steps"]) / seq_wall
            warm_agg = pop["steps"] / pop["steady_s"]
            warm_seq = base["steps"] / base["steady_s"]
            row = {"P": P, "lane_mode": lane_mode, "task": TASK,
                   "algo": "ddpg", "encoder": ENCODER, "regime": regime,
                   "total_steps_per_member": total_steps, "n_envs": n_envs,
                   "population_steps": pop["steps"],
                   "population_wall_s": pop["wall_s"],
                   "population_steady_s": pop["steady_s"],
                   "sequential_wall_s": seq_wall,
                   "sequential_steady_s": P * base["steady_s"],
                   "aggregate_steps_per_sec": agg_sps,
                   "sequential_steps_per_sec": seq_sps,
                   "steady_aggregate_steps_per_sec": warm_agg,
                   "steady_sequential_steps_per_sec": warm_seq,
                   "speedup_vs_sequential": warm_agg / warm_seq,
                   "first_pass_speedup_vs_sequential": agg_sps / seq_sps}
            rows.append(row)
            print(f"  {lane_mode:<5} P={P:<3} warm {warm_agg:8.1f} agg "
                  f"steps/s vs sequential {warm_seq:8.1f}: "
                  f"{row['speedup_vs_sequential']:.2f}x (first passes "
                  f"{agg_sps:8.1f} vs {seq_sps:8.1f}: "
                  f"{row['first_pass_speedup_vs_sequential']:.2f}x)")
    return rows


@contextlib.contextmanager
def deterministic(device):
    """cuDNN and cuBLAS in their deterministic modes on a GPU (the
    workspace setting must precede cuBLAS's first use in the process to
    take effect); nothing to do on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def check_member0_parity(*, total_steps: int = 32, device=None) -> dict:
    """Member 0 of a P=2 population (WITH gradient updates — tiny config
    so the update path is exercised, not just collection) vs a single
    ``train()`` run at the same seed: params and episode returns must be
    bitwise identical."""
    dev = resolve_device(device)
    small = {"batch_size": 8, "buffer_size": 64, "learning_starts": 8,
             "n_envs": 2}
    spec = PopulationSpec(tasks=(TASK,), seeds=(0, 1),
                          total_steps=total_steps, encoder=ENCODER,
                          cfg_overrides=small)
    with deterministic(dev):
        pop = train_population(spec, eval_episodes=0, device=dev)
        single = train(TASK, ENCODER, total_steps=total_steps, seed=0,
                       cfg=DDPGConfig(**small), device=dev)
    m0 = pop.members[0]
    params_equal = all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(m0.params),
                           tree_leaves(single.params)))
    returns_equal = (m0.episode_returns == single.episode_returns
                     and m0.truncated_returns == single.truncated_returns)
    row = {"total_steps": total_steps, "n_members": len(pop.members),
           "params_bitwise": bool(params_equal),
           "returns_bitwise": bool(returns_equal),
           "bitwise": bool(params_equal and returns_equal)}
    print(f"  member-0 parity (P=2, with updates): params "
          f"{'BITWISE' if params_equal else 'DIFFER'}, returns "
          f"{'BITWISE' if returns_equal else 'DIFFER'}")
    return row


def check_eval_protocol(*, n_episodes: int = 4, max_steps: int = 40,
                        seed: int = 7, device=None) -> dict:
    """The final-100-episode protocol on a shortened window: same seed
    twice must replay bitwise, and the summary metric must be finite."""
    dev = resolve_device(device)
    env = make_pixel_env(TASK, train=False)
    encoder = _pipeline_encoder(ENCODER, env.obs_shape[-1], device=dev)
    agent = make_agent("ddpg", encoder, env.action_dim, device=dev)
    params = agent.init(torch.Generator().manual_seed(0)).params
    r1 = evaluate(agent, params, n_episodes, env=env, seed=seed,
                  max_steps=max_steps)
    r2 = evaluate(agent, params, n_episodes, env=env, seed=seed,
                  max_steps=max_steps)
    row = {"n_episodes": n_episodes, "max_steps": max_steps,
           "final_100_mean": final_100_mean(r1),
           "bitwise_replay": bool(np.array_equal(r1, r2))}
    print(f"  eval protocol: replay "
          f"{'BITWISE' if row['bitwise_replay'] else 'DIFFERS'}, "
          f"final_100_mean={row['final_100_mean']:.1f} "
          f"({n_episodes} episodes x {max_steps} steps)")
    return row


def write_bench(rows, parity, eval_row, *, total_steps: int,
                path: str = ARTIFACT, device=None) -> dict:
    dev = resolve_device(device)
    doc = perfstamp.stamp({
        "benchmark": "population",
        "host_detail": {"platform": platform.platform(),
                        "device": str(dev)},
        "total_steps_per_member": total_steps,
        "lane_modes": sorted({r["lane_mode"] for r in rows}),
        "rows": rows,
        "member0_parity": parity,
        "eval_protocol": eval_row,
    }, device=dev)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(doc, indent=2))
    print(f"  wrote {path}")
    return doc


def check_smoke(doc: dict) -> None:
    """The population engine's gate (see the module docstring)."""
    assert doc["member0_parity"]["bitwise"], \
        "member 0 of the population is not bitwise-equal to the " \
        "single-run engine"
    ev = doc["eval_protocol"]
    assert ev["bitwise_replay"], "eval protocol is not deterministic"
    assert np.isfinite(ev["final_100_mean"]), \
        f"non-finite eval metric: {ev['final_100_mean']}"
    for r in doc["rows"]:
        assert r["aggregate_steps_per_sec"] > 0, \
            f"{r['lane_mode']} P={r['P']}: zero agg"
    vmap = {r["P"]: r for r in doc["rows"] if r["lane_mode"] == "vmap"}
    assert vmap, "no vmap lanes measured"
    for P, r in vmap.items():
        if P > 1:
            assert r["speedup_vs_sequential"] >= 1.0, \
                f"vmap P={P}: population slower than sequential " \
                f"({r['speedup_vs_sequential']:.2f}x)"
    top = max(vmap)
    sp = vmap[top]["speedup_vs_sequential"]
    assert sp >= SMOKE_SPEEDUP, \
        f"vmap P={top} aggregate throughput only {sp:.2f}x sequential " \
        f"(< {SMOKE_SPEEDUP:g}x)"
    print(f"  smoke gate OK: vmap P={top} {sp:.1f}x sequential, member-0 "
          "bitwise, eval deterministic")


def compare_against(doc: dict, against_path: str) -> None:
    """Refuse cross-mode comparisons; report per-(lane, P) speedup
    deltas."""
    old = json.loads(Path(against_path).read_text())
    try:
        perfstamp.check_comparable(old, doc, what="population benchmarks")
    except ValueError as e:
        print(f"  --against: {e}")
        sys.exit(2)
    old_rows = {(r.get("lane_mode", "exact"), r["P"]): r
                for r in old.get("rows", [])}
    for r in doc["rows"]:
        o = old_rows.get((r["lane_mode"], r["P"]))
        if o is None:
            continue
        print(f"  {r['lane_mode']} P={r['P']}: speedup "
              f"{o['speedup_vs_sequential']:.1f}x -> "
              f"{r['speedup_vs_sequential']:.1f}x; agg steps/s "
              f"{o['aggregate_steps_per_sec']:.1f} -> "
              f"{r['aggregate_steps_per_sec']:.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=64,
                    help="collection steps per member")
    ap.add_argument("--pops", default=",".join(map(str, DEFAULT_POPS)))
    ap.add_argument("--n-envs", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="gate: vmap lanes >= 3x sequential at the largest "
                         "P, member-0 bitwise parity, deterministic eval")
    ap.add_argument("--against", default=None,
                    help="prior population.json to diff against (refuses "
                         "cross-mode artifacts)")
    ap.add_argument("--json", default=ARTIFACT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the port never falls back")
    args = ap.parse_args(argv)
    pops = tuple(int(p) for p in args.pops.split(","))

    rows = run_grid(pops, total_steps=args.steps, n_envs=args.n_envs,
                    device=args.device)
    parity = check_member0_parity(device=args.device)
    eval_row = check_eval_protocol(device=args.device)
    doc = write_bench(rows, parity, eval_row, total_steps=args.steps,
                      path=args.json, device=args.device)
    if args.against:
        compare_against(doc, args.against)
    if args.smoke:
        check_smoke(doc)
    return doc


if __name__ == "__main__":
    main()
