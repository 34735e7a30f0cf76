"""Population training: seeds × hyperparameter variants × tasks in one
engine, plus the paper's final-100-episode eval protocol (port of
``repro.rl.population``).

A single run trains one agent at a time.  A population trains P
candidate members together: the members of one *program* (a task and a
static config) share the env, the encoder pipeline and every shape, and
differ in their seed and in the fields of their config's ``VMAPPABLE``
set (hyperparameters that only feed arithmetic).  Members whose configs
differ in a static field (shapes, loop lengths, buffer sizes) cannot
share a program — :meth:`PopulationSpec.programs` groups them — and tasks
always get their own.

Two lane modes (``lane_mode``):

* ``"exact"`` (default) — each member's carry is advanced by the
  unchanged single-run bodies (``offpolicy_chunk_fn`` /
  ``onpolicy_iter_fn``), one member after another, with the member's own
  generators made as ``train(seed=m.seed)`` makes them.  Member p is
  therefore bit for bit a ``train()`` run at its seed and config.
* ``"vmap"`` — batched lanes.  The members' ``TrainState``s are stacked
  on a leading ``(P,)`` axis; ``act`` and ``update`` run under
  ``torch.func.vmap`` with each member's hyperparameters as 0-d tensors
  in its config, so one launch does the work of P members.  Every random
  draw is made outside the vmap from each member's own generator, in the
  order the exact lane makes it, and passed in (``noise=``).  The env
  step (``PixelEnv.step_population``) and the replay ring (``(P,
  capacity, ...)``, one host-int cursor, each member's indices from its
  own generator) run on the stacked tensors outside the vmap.  Batched
  convolutions and gradients sum in another order than the unbatched
  ones, so the lanes drift from the exact lanes by float32 rounding
  (the reference's vmap lanes drift the same way).

Evaluation follows the paper's protocol ("mean over the final 100
episodes"): :func:`make_evaluator` runs E parallel episodes of
``Agent.policy_head`` (no exploration noise) on a ``train=False`` env
(centre crop), summing each episode's rewards until its first done; the
same (params, seed) replays bitwise.  :func:`make_population_evaluator`
scores every member on the SAME episode seeds, so
:meth:`PopulationResult.best_member` is a paired pick, and
``Deployment.export_best`` serves the winner from a manifest.

Where the reference splits ``jax.random`` keys per member
(``split_member_keys``), the port gives each member the (CPU init
generator, device run generator) pair ``rollout._generators(seed,
device)`` makes for a single run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.envs import make_pixel_env
from repro_torch.envs.wrappers import PixelEnv
from repro_torch.nn.module import tree_leaves
from repro_torch.rl.agent import Agent, TrainState, _algorithms, act_noise, \
    make_agent
from repro_torch.rl.buffers import (buffer_add_u8, device_buffer,
                                    population_sample, quantize_obs)
from repro_torch.rl.rollout import (Engine, OffPolicyCarry, OnPolicyCarry,
                                    _accumulate, _generators, _mean_metrics,
                                    offpolicy_capacity, offpolicy_chunk_fn,
                                    offpolicy_init_fn, offpolicy_plan,
                                    onpolicy_init_fn, onpolicy_iter_fn,
                                    onpolicy_plan, to_host)
from repro_torch.rl.train import (TASK_ALGO, _flush_truncated,
                                  _pipeline_encoder, _track_episodes)
from repro_torch.schema import check_version

SPEC_VERSION = 1


# ---------------------------------------------------------------------------
# Spec: which members exist, and which programs they form
# ---------------------------------------------------------------------------

def _canon_pairs(overrides) -> tuple:
    """Canonicalise a ``{field: value}`` mapping (dict or key/value pairs)
    into a sorted tuple of pairs, so two specs naming the same overrides in
    a different order are equal (and hashable inside the frozen spec)."""
    items = overrides.items() if isinstance(overrides, dict) \
        else (tuple(p) for p in overrides)
    return tuple(sorted((str(k), v) for k, v in items))


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """P = tasks × variants × seeds members of one encoder family.

    ``variants`` is a sequence of per-member config overrides (dicts or
    key/value pairs); ``cfg_overrides`` applies to every member first.
    Overrides of a config's ``VMAPPABLE`` fields stack into one program;
    any other (static) override splits the program.  Member order is
    task-major, then variant, then seed — :meth:`members` is the single
    source of truth.
    """

    tasks: tuple
    seeds: tuple
    variants: tuple = ((),)
    encoder: str = "miniconv4"
    total_steps: int = 512
    cfg_overrides: tuple = ()

    def __post_init__(self):
        tasks = (self.tasks,) if isinstance(self.tasks, str) else self.tasks
        object.__setattr__(self, "tasks", tuple(tasks))
        object.__setattr__(self, "seeds",
                           tuple(int(s) for s in self.seeds))
        variants = tuple(_canon_pairs(v) for v in self.variants) or ((),)
        object.__setattr__(self, "variants", variants)
        object.__setattr__(self, "cfg_overrides",
                           _canon_pairs(self.cfg_overrides))
        if not self.tasks:
            raise ValueError("PopulationSpec needs at least one task")
        if not self.seeds:
            raise ValueError("PopulationSpec needs at least one seed")
        for task in self.tasks:
            if task not in TASK_ALGO:
                raise ValueError(f"unknown task {task!r}; one of: "
                                 f"{', '.join(TASK_ALGO)}")

    @property
    def n_members(self) -> int:
        return len(self.tasks) * len(self.variants) * len(self.seeds)

    def members(self) -> list["Member"]:
        out: list[Member] = []
        for task in self.tasks:
            for vi, variant in enumerate(self.variants):
                for seed in self.seeds:
                    out.append(Member(index=len(out), task=task,
                                      algo=TASK_ALGO[task], seed=seed,
                                      variant_index=vi,
                                      overrides=dict(variant)))
        return out

    def programs(self) -> list["Program"]:
        """Members grouped into programs that share one engine.

        Each group shares (task, static config); vmappable overrides
        become per-member hyperparameter columns, missing entries filled
        from the group's static config so every column is stackable.
        """
        algos = _algorithms()
        groups: dict = {}
        order: list = []
        for m in self.members():
            config_cls = algos[m.algo][0]
            field_names = {f.name for f in dataclasses.fields(config_cls)}
            vmappable = getattr(config_cls, "VMAPPABLE", frozenset())
            for k in list(dict(self.cfg_overrides)) + list(m.overrides):
                if k not in field_names:
                    raise ValueError(
                        f"{config_cls.__name__} has no field {k!r} "
                        f"(member {m.index}, task {m.task!r})")
            base = config_cls(**dict(self.cfg_overrides))
            static = {k: v for k, v in m.overrides.items()
                      if k not in vmappable}
            hyper = {k: v for k, v in m.overrides.items() if k in vmappable}
            static_cfg = dataclasses.replace(base, **static)
            gkey = (m.task, static_cfg)
            if gkey not in groups:
                groups[gkey] = Program(task=m.task, algo=m.algo,
                                       static_cfg=static_cfg, members=[],
                                       hyper_fields=())
                order.append(gkey)
            prog = groups[gkey]
            prog.members.append(m)
            prog.hyper_fields = tuple(sorted(set(prog.hyper_fields)
                                             | set(hyper)))
        return [groups[k] for k in order]

    def to_dict(self) -> dict:
        return {"version": SPEC_VERSION,
                "tasks": list(self.tasks),
                "seeds": list(self.seeds),
                "variants": [[list(p) for p in v] for v in self.variants],
                "encoder": self.encoder,
                "total_steps": self.total_steps,
                "cfg_overrides": [list(p) for p in self.cfg_overrides]}

    @classmethod
    def from_dict(cls, d: dict) -> "PopulationSpec":
        d = dict(d)
        check_version("PopulationSpec", d.pop("version", None),
                      (SPEC_VERSION,))
        return cls(tasks=tuple(d["tasks"]), seeds=tuple(d["seeds"]),
                   variants=tuple(tuple(tuple(p) for p in v)
                                  for v in d.get("variants", [[]])),
                   encoder=d.get("encoder", "miniconv4"),
                   total_steps=int(d.get("total_steps", 512)),
                   cfg_overrides=tuple(tuple(p) for p in
                                       d.get("cfg_overrides", [])))


@dataclasses.dataclass
class Member:
    """One population member: identity, then results once trained."""

    index: int
    task: str
    algo: str
    seed: int
    variant_index: int
    overrides: dict

    episode_returns: list = dataclasses.field(default_factory=list)
    truncated_returns: list = dataclasses.field(default_factory=list)
    env_steps: int = 0
    params: Any = None           # trained TrainState.params tree
    eval_returns: Optional[np.ndarray] = None   # protocol eval episodes
    state: Any = None            # the whole trained TrainState (params,
                                 # targets, optimizer state)

    @property
    def final_100_mean(self) -> float:
        """Mean return over the final 100 eval episodes (paper metric);
        falls back to training episodes when the member wasn't evaluated."""
        if self.eval_returns is not None:
            return final_100_mean(self.eval_returns)
        return final_100_mean(self.episode_returns
                              or self.truncated_returns)

    def summary(self) -> dict:
        return {"member": self.index, "task": self.task, "algo": self.algo,
                "seed": self.seed, "variant": self.variant_index,
                "overrides": dict(self.overrides),
                "episodes_completed": len(self.episode_returns),
                "env_steps": self.env_steps,
                "final_100_mean": self.final_100_mean}


@dataclasses.dataclass
class Program:
    """A group of members sharing one engine (task + static config)."""

    task: str
    algo: str
    static_cfg: Any
    members: list
    hyper_fields: tuple

    def hyper_values(self) -> dict:
        """``{field: [value a member]}`` in member order, gaps filled from
        the static config so heterogeneous variants still stack."""
        return {k: [m.overrides.get(k, getattr(self.static_cfg, k))
                    for m in self.members]
                for k in self.hyper_fields}

    def hyper_arrays(self, device: DeviceLike = None) -> dict:
        """``{field: (P,) float32}`` columns of :meth:`hyper_values` on
        ``device`` (``"cuda"`` by default)."""
        dev = resolve_device(device)
        return {k: torch.tensor(v, dtype=torch.float32, device=dev)
                for k, v in self.hyper_values().items()}


def final_100_mean(returns) -> float:
    """The paper's summary statistic: mean over the last 100 episodes."""
    r = np.asarray(list(returns), dtype=np.float64).ravel()
    return float(np.mean(r[-100:])) if r.size else float("nan")


# ---------------------------------------------------------------------------
# Stacked trees
# ---------------------------------------------------------------------------

def stack_trees(trees: list):
    """Stack trees of one structure (dicts, NamedTuples and tuples of
    tensors; None stays None) leaf by leaf on a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return _rebuild(first, [stack_trees(list(x)) for x in zip(*trees)])


def member_tree(tree, p: int):
    """Member ``p`` of a stacked tree (views, no copy)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[p]
    if isinstance(tree, dict):
        return {k: member_tree(v, p) for k, v in tree.items()}
    return _rebuild(tree, [member_tree(x, p) for x in tree])


def _rebuild(like: tuple, items: list) -> tuple:
    """A tuple or NamedTuple of ``like``'s type holding ``items``."""
    return type(like)(*items) if hasattr(like, "_fields") \
        else type(like)(items)


# ---------------------------------------------------------------------------
# The population engine
# ---------------------------------------------------------------------------

LANE_MODES = ("exact", "vmap")


@dataclasses.dataclass(frozen=True)
class PopulationEngine(Engine):
    """An :class:`~repro_torch.rl.rollout.Engine` over P members:
    ``init(seeds)`` takes one seed a member, ``run(carry, phase)``
    returns ``(P, T, N)`` rewards and dones and ``(P,)`` metrics, and
    ``state(carry)`` is the members' TrainStates stacked on a leading
    ``(P,)`` axis."""

    n_members: int = 1
    lane_mode: str = "exact"
    state: Callable = None       # (carry) -> stacked TrainState


def _check_lane_mode(lane_mode: str) -> None:
    if lane_mode not in LANE_MODES:
        raise ValueError(f"lane_mode {lane_mode!r}; one of: "
                         f"{', '.join(LANE_MODES)}")


def make_population_engine(env: PixelEnv, algo: str, encoder, action_dim: int,
                           static_cfg: Any, hyper: dict, n_members: int,
                           total_steps: int, lane_mode: str = "exact", *,
                           device: DeviceLike = None) -> PopulationEngine:
    """The engine of one program of ``n_members`` members on ``device``
    (``"cuda"`` by default).  ``hyper`` maps VMAPPABLE config fields to
    one value a member (``Program.hyper_values()``); member p's config is
    ``static_cfg`` with those values.

    ``lane_mode="exact"`` runs each member through the single-run bodies
    (bitwise ``train()``), ``"vmap"`` batches the members (see the module
    docstring).  ``init`` builds each member eagerly with its own config
    and stacks, so both modes start from the same parameters.
    """
    _check_lane_mode(lane_mode)
    dev = resolve_device(device)
    P = int(n_members)
    values = {k: [float(x) for x in v] for k, v in hyper.items()}
    if any(len(v) != P for v in values.values()):
        raise ValueError(f"every hyperparameter column needs {P} values: "
                         f"{ {k: len(v) for k, v in values.items()} }")
    base_agent = make_agent(algo, encoder, action_dim, cfg=static_cfg,
                            device=dev)
    # each member's agent, its hyperparameters as Python values: an exact
    # lane is then the single run at that config
    agents = [_member_agent(base_agent, {k: v[p] for k, v in values.items()},
                            dev) for p in range(P)]
    on_policy = base_agent.on_policy
    if on_policy:
        plan = lambda: onpolicy_plan(static_cfg, total_steps)  # noqa: E731
    else:
        cap = offpolicy_capacity(static_cfg, total_steps)
        plan = lambda: offpolicy_plan(static_cfg, total_steps)  # noqa: E731

    if lane_mode == "exact":
        inits = [onpolicy_init_fn(env, a, dev) if on_policy
                 else offpolicy_init_fn(env, a, cap, dev) for a in agents]
        bodies = [onpolicy_iter_fn(env, a) if on_policy
                  else offpolicy_chunk_fn(env, a) for a in agents]

        def init(seeds) -> list:
            _check_seeds(seeds, P)
            return [inits[p](s) for p, s in enumerate(seeds)]

        def run(carry: list, phase):
            if on_policy:
                outs = [body(c) for body, c in zip(bodies, carry)]
            else:
                kind, n_steps = phase
                outs = [body(c, n_steps=n_steps, warmup=(kind == "warmup"))
                        for body, c in zip(bodies, carry)]
            metrics = {k: torch.stack([o[3][k] for o in outs])
                       for k in outs[0][3]}
            return ([o[0] for o in outs], torch.stack([o[1] for o in outs]),
                    torch.stack([o[2] for o in outs]), metrics)

        def state(carry: list) -> TrainState:
            return stack_trees([c.state for c in carry])
    else:
        lanes = BatchedLanes(algo, encoder, action_dim, static_cfg, values,
                             device=dev)
        body = (batched_iter_fn(env, lanes) if on_policy
                else batched_chunk_fn(env, lanes))

        def init(seeds):
            _check_seeds(seeds, P)
            gens = [_generators(s, dev) for s in seeds]
            states = stack_trees([a.init(g) for a, (g, _) in
                                  zip(agents, gens)])
            run_gens = tuple(g for _, g in gens)
            env_states, obs = env.reset_population(run_gens,
                                                   static_cfg.n_envs)
            if on_policy:
                return OnPolicyCarry(states, env_states, obs, run_gens)
            buf = device_buffer(cap, env.obs_shape, action_dim,
                                n_add=static_cfg.n_envs, device=dev,
                                members=P)
            return OffPolicyCarry(states, buf, env_states, obs,
                                  quantize_obs(obs), run_gens)

        def run(carry, phase):
            if on_policy:
                return body(carry)
            kind, n_steps = phase
            return body(carry, n_steps=n_steps, warmup=(kind == "warmup"))

        def state(carry) -> TrainState:
            return carry.state

    return PopulationEngine(agent=base_agent, n_envs=static_cfg.n_envs,
                            init=init, plan=plan, run=run, n_members=P,
                            lane_mode=lane_mode, state=state)


def _member_agent(base: Agent, hyper_m: dict, device) -> Agent:
    """``base``'s algorithm at ``base.cfg`` with the fields of ``hyper_m``
    (Python floats, or 0-d tensors inside ``torch.func.vmap``)."""
    if not hyper_m:
        return base
    return make_agent(base.name, base.encoder, base.action_dim,
                      cfg=dataclasses.replace(base.cfg, **hyper_m),
                      device=device)


def _check_seeds(seeds, P: int) -> None:
    if len(seeds) != P:
        raise ValueError(f"the engine has {P} members; got {len(seeds)} "
                         f"seeds")


@contextlib.contextmanager
def vmap_fallbacks():
    """Collect, while the block runs, the ops that ``torch.func.vmap``
    ran through its per-member fallback loop (an op without a batching
    rule, which launches P times): yields a list that holds their
    warnings when the block ends.  Batched lanes must leave it empty.
    Every other warning passes through when the block ends."""
    found: list = []
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as records:
            warnings.simplefilter("always")
            yield found
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    for r in records:
        if "batching rule" in str(r.message):
            found.append(str(r.message))
        else:
            warnings.warn_explicit(r.message, r.category, r.filename,
                                   r.lineno)


class BatchedLanes:
    """``act`` and ``update`` (with its target step) of the P members of
    one program as ONE call each, under ``torch.func.vmap`` over stacked
    parameters, observations, data and draws.  ``hyper`` maps VMAPPABLE
    fields to one value a member; inside the vmap each member's config
    holds its value as a 0-d tensor.  The draws are arguments: make them
    with :meth:`act_noise` and :meth:`update_noise`, from each member's
    own generator, or pass the reference's."""

    def __init__(self, algo: str, encoder, action_dim: int, static_cfg,
                 hyper: dict, *, device: DeviceLike = None):
        dev = resolve_device(device)
        self.agent = make_agent(algo, encoder, action_dim, cfg=static_cfg,
                                device=dev)
        self.hyper = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                      for k, v in hyper.items()}

        def act(hyper_m, params, obs, noise):
            return _member_agent(self.agent, hyper_m, dev).act(
                params, obs, noise=noise)

        def update(hyper_m, state, data, noise):
            a = _member_agent(self.agent, hyper_m, dev)
            state, metrics = a.update(state, data, noise=noise)
            return a.target_update(state), metrics

        self._act = torch.func.vmap(act)
        self._update = torch.func.vmap(update)
        # DDPG's update draws nothing: no noise argument to map over
        self._update_plain = torch.func.vmap(
            lambda hyper_m, state, data: update(hyper_m, state, data, None))

    def act_noise(self, gens, n: int) -> torch.Tensor:
        """Each member's ``act`` draw for ``n`` observations: ``(P, n,
        action_dim)``."""
        return torch.stack([act_noise(g, n, self.agent.action_dim)
                            for g in gens])

    def update_noise(self, gens, data):
        """Each member's update draws (``Agent.draw_noise`` on its own
        data), stacked; None for an update that draws nothing."""
        return stack_trees([self.agent.draw_noise(g, member_tree(data, p))
                            for p, g in enumerate(gens)])

    def act(self, params, obs, noise):
        """``(P, N, ...)`` obs -> ``(P, N, A)`` actions and extras."""
        return self._act(self.hyper, params, obs, noise)

    def update(self, state, data, noise):
        """One update and target step of every member: ``(stacked state,
        (P,) metrics)``."""
        if noise is None:
            return self._update_plain(self.hyper, state, data)
        return self._update(self.hyper, state, data, noise)


def batched_chunk_fn(env: PixelEnv, lanes: BatchedLanes) -> Callable:
    """``offpolicy_chunk_fn``'s body over P stacked members: each step
    makes every member's draws in the order the single-run body makes
    them, then one batched act, one population env step, one ring insert
    and ``train_freq * n_envs`` batched updates.  Returns ``(P, T, N)``
    rewards and dones and ``(P,)`` metrics."""
    cfg, A = lanes.agent.cfg, lanes.agent.action_dim
    N = cfg.n_envs
    n_updates = cfg.train_freq * N

    def run_chunk(carry: OffPolicyCarry, *, n_steps: int, warmup: bool):
        state, buf, env_states, obs, obs_u8, gens = carry
        rewards, dones, sums = [], [], {}
        for _ in range(n_steps):
            if warmup:
                action = torch.stack([
                    torch.rand((N, A), generator=g, device=g.device)
                    for g in gens]) * 2.0 - 1.0
            else:
                action, _ = lanes.act(state.params, obs,
                                      lanes.act_noise(gens, N))
            env_states, next_obs, reward, done = env.step_population(
                env_states, torch.clamp(action, -1.0, 1.0))
            next_u8 = quantize_obs(next_obs)
            buf = buffer_add_u8(buf, obs_u8, action, reward, next_u8, done)
            if not warmup:
                for _ in range(n_updates):
                    batch = population_sample(buf, cfg.batch_size, gens)
                    state, m = lanes.update(state, batch,
                                            lanes.update_noise(gens, batch))
                    _accumulate(sums, m)
            rewards.append(reward)
            dones.append(done)
            obs, obs_u8 = next_obs, next_u8
        metrics = _mean_metrics(sums, n_steps * n_updates) if sums else {}
        return (OffPolicyCarry(state, buf, env_states, obs, obs_u8, gens),
                torch.stack(rewards, 1), torch.stack(dones, 1), metrics)

    return run_chunk


def batched_iter_fn(env: PixelEnv, lanes: BatchedLanes) -> Callable:
    """``onpolicy_iter_fn``'s body over P stacked members: the rollout
    with batched acts and population env steps, then one batched
    whole-trajectory update on each member's own permutations."""
    T = lanes.agent.cfg.n_steps

    def run_iter(carry: OnPolicyCarry):
        state, env_states, obs, gens = carry
        steps = []
        for _ in range(T):
            action, extras = lanes.act(state.params, obs,
                                       lanes.act_noise(gens, obs.shape[1]))
            env_states, next_obs, reward, done = env.step_population(
                env_states, torch.clamp(action, -1.0, 1.0))
            steps.append(dict(obs=obs, action=action, reward=reward,
                              done=done, **extras))
            obs = next_obs
        traj = {k: torch.stack([s[k] for s in steps], 1) for k in steps[0]}
        data = {"traj": traj, "last_obs": obs}
        state, metrics = lanes.update(state, data,
                                      lanes.update_noise(gens, data))
        return (OnPolicyCarry(state, env_states, obs, gens), traj["reward"],
                traj["done"], metrics)

    return run_iter


# ---------------------------------------------------------------------------
# Deterministic eval: the paper's final-100-episode protocol
# ---------------------------------------------------------------------------

def _episode_loop(policy: Callable, env_states, obs, step: Callable,
                  T: int):
    """Sum each episode's rewards until its first done over ``T`` eager
    steps of ``policy`` (the auto-reset wrapper keeps stepping, the
    protocol does not)."""
    ret = torch.zeros(obs.shape[:-3], device=obs.device)
    alive = torch.ones_like(ret)
    for _ in range(T):
        action = torch.clamp(policy(obs), -1.0, 1.0)
        env_states, obs, reward, done = step(env_states, action)
        ret = ret + reward * alive
        alive = alive * (1.0 - done.to(torch.float32))
    return ret


def _episode_returns_fn(env: PixelEnv, agent: Agent, n_episodes: int,
                        max_steps: Optional[int]) -> Callable:
    """``(params, seed) -> (n_episodes,) returns`` on the parameters'
    device: E parallel episodes under the deterministic serving policy, no
    exploration, the episodes drawn from a device generator seeded with
    ``seed``."""
    E = int(n_episodes)
    T = int(max_steps if max_steps is not None else env.env.max_steps)

    @torch.no_grad()
    def episode_returns(params, seed: int):
        dev = tree_leaves(params)[0].device
        env_states, obs = env.reset_batch(
            torch.Generator(device=dev).manual_seed(seed), E)
        head = agent.policy_head(params)
        return _episode_loop(
            lambda o: head(agent.encoder.apply(params["encoder"], o)),
            env_states, obs, env.step_batch, T)

    return episode_returns


def make_evaluator(env: PixelEnv, agent: Agent, n_episodes: int = 100, *,
                   max_steps: Optional[int] = None) -> Callable:
    """``(params, seed) -> (n_episodes,) returns`` — deterministic: the
    same (params, seed) replays bitwise."""
    return _episode_returns_fn(env, agent, n_episodes, max_steps)


def make_population_evaluator(env: PixelEnv, agent: Agent,
                              n_episodes: int = 100, *,
                              max_steps: Optional[int] = None,
                              lane_mode: str = "exact") -> Callable:
    """``(stacked params, seed) -> (P, n_episodes) returns``.

    One shared ``seed``: every member is scored on the SAME episode seeds,
    so member comparisons are paired, and permuting members permutes the
    rows bitwise (lanes never interact).  In ``"exact"`` lane mode each
    row is bitwise what :func:`make_evaluator` returns for that member
    alone; ``"vmap"`` runs the policy of every member in one batched call
    and steps the P·E envs together, each member's episodes drawn from a
    generator of its own seeded with ``seed``.
    """
    _check_lane_mode(lane_mode)
    fn = _episode_returns_fn(env, agent, n_episodes, max_steps)
    if lane_mode == "exact":
        def exact(params, seed: int):
            P = tree_leaves(params)[0].shape[0]
            return torch.stack([fn(member_tree(params, p), seed)
                                for p in range(P)])
        return exact

    E = int(n_episodes)
    T = int(max_steps if max_steps is not None else env.env.max_steps)
    policy = torch.func.vmap(
        lambda p, o: agent.policy_head(p)(agent.encoder.apply(p["encoder"],
                                                              o)))

    @torch.no_grad()
    def batched(params, seed: int):
        lead = tree_leaves(params)[0]
        gens = [torch.Generator(device=lead.device).manual_seed(seed)
                for _ in range(lead.shape[0])]
        env_states, obs = env.reset_population(gens, E)
        return _episode_loop(lambda o: policy(params, o), env_states, obs,
                             env.step_population, T)

    return batched


def evaluate(agent: Agent, params, n_episodes: int = 100, *,
             env: Optional[PixelEnv] = None, task: Optional[str] = None,
             seed: int = 0, max_steps: Optional[int] = None) -> np.ndarray:
    """The paper's eval protocol in one call: ``n_episodes`` deterministic
    episodes (default 100 — "mean over the final 100 episodes") of
    ``agent.policy_head`` on a ``train=False`` (centre-crop) env, on the
    parameters' device.  Returns the per-episode returns; reduce with
    :func:`final_100_mean`.  Deterministic in ``seed``: repeated calls
    are bitwise identical.
    """
    if env is None:
        if task is None:
            raise ValueError("evaluate() needs env= or task=")
        env = make_pixel_env(task, train=False)
    fn = make_evaluator(env, agent, n_episodes, max_steps=max_steps)
    return fn(params, seed).cpu().numpy()


# ---------------------------------------------------------------------------
# Driver: train every program, eval every member, pick the winner
# ---------------------------------------------------------------------------

class ProgramRun(NamedTuple):
    """What one program's training left: its engine, the final carry
    (stacked states, envs, ring, generators) to go on from, and one
    ``(phase, wall seconds, metrics)`` a phase of the plan, the metrics
    ``(P,)`` tensors on the device as the engine returned them."""

    engine: PopulationEngine
    carry: Any
    phases: list


@dataclasses.dataclass
class PopulationResult:
    spec: PopulationSpec
    members: list
    program_stats: list
    wall_time_s: float
    runs: list = dataclasses.field(default_factory=list)  # ProgramRun each

    @property
    def aggregate_steps_per_sec(self) -> float:
        total = sum(m.env_steps for m in self.members)
        return total / self.wall_time_s if self.wall_time_s > 0 \
            else float("nan")

    def best_member(self) -> Member:
        """Winner under the paper's metric (``final_100_mean``); ties and
        all-NaN populations fall back to the lowest member index."""
        scored = [m for m in self.members
                  if np.isfinite(m.final_100_mean)]
        if not scored:
            return self.members[0]
        return max(scored, key=lambda m: m.final_100_mean)

    def best_params(self):
        return self.best_member().params

    def summary(self) -> dict:
        best = self.best_member()
        return {"n_members": len(self.members),
                "n_programs": len(self.program_stats),
                "wall_time_s": self.wall_time_s,
                "aggregate_steps_per_sec": self.aggregate_steps_per_sec,
                "best_member": best.index,
                "best_final_100_mean": best.final_100_mean,
                "members": [m.summary() for m in self.members],
                "programs": list(self.program_stats)}


def train_population(spec: PopulationSpec, *, eval_episodes: int = 100,
                     eval_seed: int = 0,
                     eval_max_steps: Optional[int] = None,
                     deploy_config=None, lane_mode: str = "exact",
                     verbose: bool = False,
                     device: DeviceLike = None) -> PopulationResult:
    """Train every member of ``spec`` on ``device`` (``"cuda"`` by
    default) — one engine per (task, static-config) program — then score
    each with the deterministic eval protocol (``eval_episodes=0`` skips
    eval; ``eval_max_steps`` shortens the episode window for smoke-scale
    runs).

    Each member draws from the generators ``train(seed=m.seed)`` would
    make; with the default ``lane_mode="exact"`` every member therefore
    reproduces a single ``train()`` run at its seed and config bitwise.
    Member results land on :attr:`PopulationResult.members` in spec
    order.  ``program_stats`` carries each program's ``wall_s`` and
    ``compile_s`` (the first call of each phase shape, as in ``train()``:
    the allocator's first allocations and cuDNN's algorithm search), and
    ``runs`` each program's :class:`ProgramRun`.
    """
    dev = resolve_device(device)
    t_start = time.time()
    stats: list = []
    runs: list = []
    all_members: list = []
    for prog in spec.programs():
        env = make_pixel_env(prog.task, train=True)
        encoder = _pipeline_encoder(spec.encoder, env.obs_shape[-1],
                                    deploy_config=deploy_config, device=dev)
        P = len(prog.members)
        engine = make_population_engine(
            env, prog.algo, encoder, env.action_dim, prog.static_cfg,
            prog.hyper_values(), P, spec.total_steps, lane_mode=lane_mode,
            device=dev)
        t0 = time.time()
        carry = engine.init([m.seed for m in prog.members])

        N = engine.n_envs
        returns: list[list[float]] = [[] for _ in range(P)]
        ep_ret = np.zeros((P, N))
        ep_len = np.zeros((P, N), np.int64)
        env_steps = 0
        compile_s = 0.0
        seen: set = set()
        phases = []
        for it, phase in enumerate(engine.plan()):
            t_call = time.time()
            carry, rewards, dones, metrics = engine.run(carry, phase)
            # the phase's one host copy: every member's rewards and dones
            rewards, dones = to_host(rewards, dones)     # (P, T, N)
            dt = time.time() - t_call
            phases.append((phase, dt, metrics))
            if phase not in seen:
                seen.add(phase)
                compile_s += dt
            for p in range(P):
                ep_ret[p], ep_len[p] = _track_episodes(
                    returns[p], ep_ret[p], ep_len[p], rewards[p], dones[p])
            env_steps += int(rewards[0].size)
            if verbose:
                print(f"  [population {prog.task}/{prog.algo} P={P} "
                      f"{lane_mode}] {phase[0]} {it} episodes="
                      f"{sum(len(r) for r in returns)}")

        state = engine.state(carry)
        for p, m in enumerate(prog.members):
            m.episode_returns = returns[p]
            m.truncated_returns = _flush_truncated(ep_ret[p], ep_len[p])
            m.env_steps = env_steps
            m.state = member_tree(state, p)
            m.params = m.state.params

        if eval_episodes:
            eval_env = make_pixel_env(prog.task, train=False)
            evaluator = make_population_evaluator(
                eval_env, engine.agent, eval_episodes,
                max_steps=eval_max_steps, lane_mode=lane_mode)
            rets = evaluator(state.params, eval_seed).cpu().numpy()
            for p, m in enumerate(prog.members):
                m.eval_returns = rets[p]

        stats.append({"task": prog.task, "algo": prog.algo, "n_members": P,
                      "hyper_fields": list(prog.hyper_fields),
                      "env_steps_per_member": env_steps,
                      "wall_s": time.time() - t0, "compile_s": compile_s,
                      "lane_mode": lane_mode})
        runs.append(ProgramRun(engine, carry, phases))
        all_members.extend(prog.members)

    all_members.sort(key=lambda m: m.index)
    return PopulationResult(spec=spec, members=all_members,
                            program_stats=stats,
                            wall_time_s=time.time() - t_start, runs=runs)


__all__ = ["SPEC_VERSION", "LANE_MODES", "BatchedLanes", "PopulationSpec",
           "Member", "Program", "PopulationEngine", "PopulationResult",
           "ProgramRun",
           "batched_chunk_fn", "batched_iter_fn",
           "final_100_mean", "make_population_engine", "make_evaluator",
           "make_population_evaluator", "evaluate", "member_tree",
           "stack_trees", "train_population", "vmap_fallbacks"]
