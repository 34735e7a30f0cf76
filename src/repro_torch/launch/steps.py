"""Step-function builders: (arch x shape x mesh) -> a step over DTensors
with the placements of each argument, plus the abstract inputs to trace it
with, as in ``repro.launch.steps``.

One bundle per shape kind:

  train_4k     -> train_step(params, opt_state, batch) (loss+grad+adamw)
  prefill_32k  -> prefill_step(params, batch) -> last-position logits
  decode_32k / long_500k -> serve_step(params, token, caches, index)

Where the reference jits the step with in/out shardings and lowers it,
the port runs it eagerly on DTensors: every argument leaf is a DTensor
whose placements come from ``models.sharding``, and layer code
redistributes activations at the reference's places
(``nn.constrain``).  :meth:`StepBundle.trace` runs the step once over
``meta`` DTensors under the cost counter (``repro_torch.costs``) — the
counterpart of ``lower().compile()`` with its cost and memory analyses —
and :meth:`StepBundle.run` runs it on real tensors.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.costs import CostCounter
from repro_torch.models import sharding as shd
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.registry import (abstract_params, build_model,
                                         input_specs_for, long_ctx)
from repro_torch.nn.constrain import RegatherReshapes
from repro_torch.nn.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.optimizer import Optimizer, OptState, adamw


@dataclasses.dataclass
class Traced:
    """What a trace saw: the cost counter of the run (per-chip FLOPs,
    bytes, collective bytes, peak live bytes: a ``CostCounter``, or the
    :class:`Counts` that :func:`trace_step` extrapolates), the outputs
    (meta DTensors; None when extrapolated) and the seconds the trace
    took."""
    counter: Any
    outputs: Any
    trace_s: float


def _map2(fn, tree, pl):
    """``fn(leaf, placements)`` over a tree and its placement tree
    (dicts, tuples and the optimizer's ``OptState``)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, pl[k]) for k, v in tree.items()}
    if isinstance(tree, OptState):
        return OptState(*(_map2(fn, t, p) for t, p in zip(tree, pl)))
    return fn(tree, pl)


def _local_shape(shape, mesh, pl) -> tuple:
    local = list(shape)
    for size, p in zip(mesh.shape, pl):
        if p.is_shard():
            local[p.dim] //= size
    return tuple(local)


def _meta_dtensor(t, mesh, pl):
    """A DTensor of ``t``'s global shape and dtype on ``mesh``, its local
    shard an empty meta tensor."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(_local_shape(t.shape, mesh, pl), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _real_dtensor(t, mesh, pl):
    """``t`` (the whole tensor) as a DTensor with placements ``pl``: on a
    one-rank mesh the local shard is ``t`` itself."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if math.prod(mesh.shape) == 1:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl)


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable
    args: tuple                 # meta tensor trees (global shapes)
    in_placements: tuple        # one placement tree per argument
    donate: tuple = ()          # arguments the step replaces

    def shard(self, mesh, *args, meta: bool = False) -> tuple:
        """``args`` (trees of whole tensors) as DTensor trees with the
        bundle's placements; with ``meta``, empty stand-ins of them."""
        make = _meta_dtensor if meta else _real_dtensor
        return tuple(_map2(lambda t, pl: make(t, mesh, pl), a, pl)
                     for a, pl in zip(args, self.in_placements))

    def trace(self, mesh) -> Traced:
        """Run the step once over meta DTensors of ``args`` under a cost
        counter: nothing is allocated and nothing launched."""
        args = self.shard(mesh, *self.args, meta=True)
        # repro: allow(timing-warmup) -- times a trace over meta tensors: nothing is allocated or launched on a device
        t0 = time.perf_counter()
        with CostCounter("meta") as counter:
            counter.track(args)
            out = self.fn(*args)
        return Traced(counter, out, time.perf_counter() - t0)

    def run(self, mesh, *real_args):
        """The step on real tensors (whole, on this process's device),
        distributed with the bundle's placements.  Returns its outputs
        (DTensor trees)."""
        return self.fn(*self.shard(mesh, *real_args))


@dataclasses.dataclass
class Counts:
    """A cost counter's totals (``repro_torch.costs.CostCounter``'s fields),
    as :func:`trace_step` extrapolates them."""
    flops: int
    bytes_accessed: int
    bytes_fused: int
    coll_breakdown: dict
    peak_bytes: int
    ops: int

    @classmethod
    def of(cls, c) -> "Counts":
        return cls(c.flops, c.bytes_accessed, c.bytes_fused,
                   dict(c.coll_breakdown), c.peak_bytes, c.ops)

    def at_depth(self, deeper: "Counts", k: int, n: int) -> "Counts":
        """Counts at ``n`` repeated blocks, from ``self`` at ``k`` and
        ``deeper`` at ``k + 1``: one block's share times ``n - k`` more."""
        def ext(a, b):
            return a + (n - k) * (b - a)
        return Counts(
            ext(self.flops, deeper.flops),
            ext(self.bytes_accessed, deeper.bytes_accessed),
            ext(self.bytes_fused, deeper.bytes_fused),
            {kind: ext(v, deeper.coll_breakdown[kind])
             for kind, v in self.coll_breakdown.items()},
            ext(self.peak_bytes, deeper.peak_bytes),
            ext(self.ops, deeper.ops))


def _depth_overrides(cfg: ArchConfig, k: int) -> Optional[dict]:
    """Overrides that cut ``cfg`` to ``k`` repetitions of its repeated
    block (a decoder's super-block; Whisper's encoder and decoder layer
    together), or None where it has no such block to repeat."""
    if cfg.family == "audio":
        if cfg.n_layers != cfg.n_encoder_layers:
            return None
        return {"n_layers": k, "n_encoder_layers": k}
    if cfg.n_pattern < 1:
        return None
    return {"n_pattern": k,
            "n_layers": k * len(cfg.pattern) + len(cfg.remainder)}


EXTRAPOLATE_FROM = 2    # the shallower of trace_step's two depths


def repeats(cfg: ArchConfig) -> int:
    """How many times :func:`_depth_overrides`'s block repeats in
    ``cfg``."""
    return cfg.n_layers if cfg.family == "audio" else cfg.n_pattern


def trace_step(arch_id: str, shape_id: str, mesh, *,
               overrides: Optional[dict] = None,
               shape: Optional[ShapeConfig] = None,
               extrapolate: bool = True) -> Traced:
    """The step's per-chip counts on ``mesh``, from meta traces.

    Every repeated block of a model runs the same local ops at the same
    shapes, so past the first its counts grow by the same amount a block:
    with ``extrapolate`` the step is traced at ``EXTRAPOLATE_FROM`` blocks
    and at one more, and the counts are carried to the model's depth (the
    reference's HLO walk multiplies a scanned body by its trip count the
    same way).  One block is not a base: a stack of one layer takes other
    layouts than a deeper one.  A first untimed trace fills DTensor's
    layout caches, whose misses run bookkeeping ops of their own.
    Without ``extrapolate``, or where the model is no deeper than the
    base, the whole step is traced after a warm-up trace of its own."""
    cfg, _ = _apply_overrides(get_config(arch_id), overrides)
    n, k = repeats(cfg), EXTRAPOLATE_FROM
    if not extrapolate or _depth_overrides(cfg, k) is None or n <= k + 1:
        bundle = make_step(arch_id, shape_id, mesh, overrides=overrides,
                           shape=shape)
        bundle.trace(mesh)
        t = bundle.trace(mesh)
        return Traced(Counts.of(t.counter), t.outputs, t.trace_s)
    over = dict(overrides or {})
    b1, b2 = (make_step(arch_id, shape_id, mesh, shape=shape,
                        overrides={**over, **_depth_overrides(cfg, d)})
              for d in (k, k + 1))
    b1.trace(mesh)
    t1, t2 = b1.trace(mesh), b2.trace(mesh)
    counts = Counts.of(t1.counter).at_depth(Counts.of(t2.counter), k, n)
    return Traced(counts, None, t1.trace_s + t2.trace_s)


# overrides consumed by the step builder rather than ArchConfig
STEP_KEYS = ("microbatches", "param_mode")


def _apply_overrides(cfg: ArchConfig, overrides: Optional[dict]):
    if not overrides:
        return cfg, {}
    step_opts = {k: v for k, v in overrides.items() if k in STEP_KEYS}
    arch_over = {k: v for k, v in overrides.items() if k not in STEP_KEYS}
    return (dataclasses.replace(cfg, **arch_over) if arch_over else cfg,
            step_opts)


def _sharded(mesh, batch: int):
    """The activation context of a step: ``activation_sharding``,
    DTensor's implicit replication of the plain tensors layer code makes
    (positions, masks, constants), and reshapes that regather a shard they
    would split (``nn.constrain.RegatherReshapes``)."""
    from contextlib import ExitStack
    from torch.distributed.tensor.experimental import implicit_replication
    stack = ExitStack()
    stack.enter_context(shd.activation_sharding(mesh, batch))
    stack.enter_context(implicit_replication())
    stack.enter_context(RegatherReshapes())
    return stack


def _batch_placements(batch_s, mesh):
    return tree_map(lambda x: shd.placements(
        shd.data_spec(mesh, x.ndim, x.shape[0]), mesh), batch_s)


def make_step(arch_id: str, shape_id: str, mesh, *,
              overrides: Optional[dict] = None,
              optimizer: Optional[Optimizer] = None,
              shape: Optional[ShapeConfig] = None) -> StepBundle:
    """``shape`` replaces ``SHAPES[shape_id]`` (a cut batch or length)."""
    kind = (shape or SHAPES[shape_id]).kind
    if kind == "train":
        return make_train_step(arch_id, shape_id, mesh, overrides=overrides,
                               optimizer=optimizer, shape=shape)
    if kind == "prefill":
        return make_prefill_step(arch_id, shape_id, mesh,
                                 overrides=overrides, shape=shape)
    return make_decode_step(arch_id, shape_id, mesh, overrides=overrides,
                            shape=shape)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_train_step(arch_id: str, shape_id: str, mesh, *,
                    overrides: Optional[dict] = None,
                    optimizer: Optional[Optimizer] = None,
                    shape: Optional[ShapeConfig] = None) -> StepBundle:
    cfg, step_opts = _apply_overrides(get_config(arch_id), overrides)
    model = build_model(cfg)
    optimizer = optimizer or adamw(3e-4, clip_norm=1.0)

    shape = shape or SHAPES[shape_id]
    n_micro = int(step_opts.get("microbatches", 1))

    def grads_of(params, batch):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = model.loss(tree_unflatten(params, leaves), batch,
                                   remat=cfg.remat)
            grads = torch.autograd.grad(loss, leaves)
        return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
                tree_unflatten(params, list(grads)))

    def train_step(params, opt_state, batch):
        with _sharded(mesh, shape.global_batch // max(n_micro, 1)):
            if n_micro <= 1:
                (loss, aux), grads = grads_of(params, batch)
            else:
                # gradient accumulation: peak activation memory scales
                # with the microbatch, grads/optimizer unchanged
                micro = tree_map(
                    lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                                        + x.shape[1:]), batch)
                acc = None
                for i in range(n_micro):
                    (l, a), g = grads_of(params,
                                         tree_map(lambda x: x[i], micro))
                    acc = ((l, a), g) if acc is None else (
                        (acc[0][0] + l,
                         {k: acc[0][1][k] + a[k] for k in a}),
                        tree_map(torch.add, acc[1], g))
                (loss, aux), grads = acc
                scale = 1.0 / n_micro
                loss = loss * scale
                aux = {k: v * scale for k, v in aux.items()}
                grads = tree_map(lambda g: g * scale, grads)
            new_params, new_opt = optimizer.update(params, opt_state, grads)
        metrics = {"loss": loss, **aux}
        return new_params, new_opt, metrics

    params_s = abstract_params(model)
    opt_s = optimizer.init(params_s)
    batch_s = input_specs_for(cfg, shape)["batch"]

    pmode = step_opts.get("param_mode", "fsdp_tp")
    p_sh = shd.param_shardings(params_s, mesh, mode=pmode)
    o_sh = OptState(shd.replicated(mesh),
                    shd.param_shardings(opt_s.mu, mesh, mode=pmode),
                    shd.param_shardings(opt_s.nu, mesh, mode=pmode))

    return StepBundle(
        name=f"train:{arch_id}:{shape_id}",
        fn=train_step,
        args=(params_s, opt_s, batch_s),
        in_placements=(p_sh, o_sh, _batch_placements(batch_s, mesh)),
        donate=(0, 1),
    )


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def make_prefill_step(arch_id: str, shape_id: str, mesh, *,
                      overrides: Optional[dict] = None,
                      shape: Optional[ShapeConfig] = None) -> StepBundle:
    cfg, step_opts = _apply_overrides(get_config(arch_id), overrides)
    model = build_model(cfg)

    shape = shape or SHAPES[shape_id]

    def prefill_step(params, batch):
        # inference: without autograd, so the attention cores take K5
        with torch.no_grad(), _sharded(mesh, shape.global_batch):
            logits, _ = model.forward(
                params, batch.get("tokens"),
                frontend_embeds=batch.get("frontend_embeds"),
                remat=cfg.remat, last_only=True)
        # next-token logits: the head runs on the last position only
        return logits[:, -1]

    params_s = abstract_params(model)
    batch_s = input_specs_for(cfg, shape)["batch"]
    p_sh = shd.param_shardings(params_s, mesh,
                               mode=step_opts.get("param_mode", "fsdp_tp"))

    return StepBundle(
        name=f"prefill:{arch_id}:{shape_id}",
        fn=prefill_step,
        args=(params_s, batch_s),
        in_placements=(p_sh, _batch_placements(batch_s, mesh)),
    )


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def make_decode_step(arch_id: str, shape_id: str, mesh, *,
                     overrides: Optional[dict] = None,
                     shape: Optional[ShapeConfig] = None) -> StepBundle:
    cfg, step_opts = _apply_overrides(get_config(arch_id), overrides)
    model = build_model(cfg)
    shape = shape or SHAPES[shape_id]
    lc = long_ctx(shape_id)

    def serve_step(params, token, caches, index):
        # the caches are written in place (decode_step's own contract)
        with _sharded(mesh, shape.global_batch):
            logits, new_caches = model.decode_step(params, token, caches,
                                                   index, long_ctx=lc)
        return logits, new_caches

    params_s = abstract_params(model)
    spec = input_specs_for(cfg, shape)
    p_sh = shd.param_shardings(params_s, mesh,
                               mode=step_opts.get("param_mode", "fsdp_tp"))
    t_sh = shd.placements(shd.data_spec(mesh, 2, shape.global_batch), mesh)
    c_sh = shd.cache_shardings(spec["caches"], mesh, shape.global_batch)
    i_sh = shd.replicated(mesh)

    return StepBundle(
        name=f"decode:{arch_id}:{shape_id}",
        fn=serve_step,
        args=(params_s, spec["token"], spec["caches"], spec["index"]),
        in_placements=(p_sh, t_sh, c_sh, i_sh),
        donate=(2,),
    )


__all__ = ["Counts", "STEP_KEYS", "StepBundle", "Traced",
           "make_decode_step", "make_prefill_step", "make_step",
           "make_train_step", "repeats", "trace_step"]
