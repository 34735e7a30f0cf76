"""Optimizers as pure transforms over dicts of tensors (port of
``repro.train.optimizer``).

adam / adamw / sgd with optional global-norm clipping and LR schedules.
The state mirrors the params: ``OptState(step, mu, nu)`` with ``step`` a
0-d int32 tensor on the params' device, so an update never reads the
device from the host.  The arithmetic is the reference's, operation by
operation in float32 (the bias corrections ``1 - b ** step`` included);
each runs as one multi-tensor (``torch._foreach_*``) call over every leaf,
so an update costs a few launches whatever the number of leaves.

Under ``torch.func.vmap`` (a population's batched lanes,
``repro_torch.rl.population``) the leaves are batched tensors, for which
the multi-tensor ops have no batching rule.  There each function packs
the leaves into one vector a member (one concatenation), runs the same
arithmetic on it, and hands back views in the leaves' shapes: the norm
and the clip are then each member's own, and a hyperparameter such as
``lr`` may be a 0-d tensor that differs between members.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.nn.module import tree_leaves, tree_map, tree_unflatten

Params = Any
Schedule = Callable[[torch.Tensor], Union[float, torch.Tensor]]


class OptState(NamedTuple):
    step: torch.Tensor           # () int32, on the params' device
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], tuple[Params, OptState]]


def constant_schedule(lr: float) -> Schedule:
    # a Python float: an f32 tensor times it multiplies by float32(lr),
    # which is the reference's ``jnp.asarray(lr, float32)``
    return lambda step: lr


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Schedule:
    def sched(step):
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return sched


def batched(leaves: list) -> bool:
    """Whether ``leaves`` are batched tensors inside ``torch.func.vmap``."""
    return bool(leaves) and torch._C._functorch.is_batchedtensor(leaves[0])


def pack(leaves: list) -> torch.Tensor:
    """The leaves as one float32 vector (per member under vmap)."""
    return torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])


def unpack(flat: torch.Tensor, like: list) -> list:
    """Views of ``flat`` in the shapes and dtypes of ``like``."""
    out, i = [], 0
    for x in like:
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  One
    multi-tensor norm: the same value as the reference's sum of per-leaf
    sums up to float32 rounding."""
    leaves = [x.to(torch.float32) for x in tree_leaves(tree)]
    if batched(leaves):
        return torch.linalg.vector_norm(pack(leaves))
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Params, max_norm: float) -> Params:
    scale = _clip_scale(global_norm(tree), max_norm)
    leaves = tree_leaves(tree)
    if batched(leaves):
        return tree_unflatten(tree, [x * scale for x in leaves])
    return tree_unflatten(tree, torch._foreach_mul(leaves, scale))


def _zeros_state(params) -> Params:
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def adam(lr: float | Schedule, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         clip_norm: Optional[float] = None) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return OptState(_step0(params), _zeros_state(params),
                        _zeros_state(params))

    def update(params, state, grads):
        p = tree_leaves(params)
        if batched(p):
            return _packed_update(params, state, grads)
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(b1, stepf)
        b2c = 1 - torch.pow(b2, stepf)

        g = [x.to(torch.float32) for x in tree_leaves(grads)]
        m = tree_leaves(state.mu)
        v = tree_leaves(state.nu)
        mu = torch._foreach_add(torch._foreach_mul(m, b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(torch._foreach_mul(v, b2),
                                torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        mhat = torch._foreach_div(mu, b1c)
        vhat = torch._foreach_div(nu, b2c)
        denom = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
        delta = torch._foreach_div(torch._foreach_mul(mhat, lr_t), denom)
        pf = [x.to(torch.float32) for x in p]
        if weight_decay:
            delta = torch._foreach_add(
                delta, torch._foreach_mul(pf, lr_t * weight_decay))
        new = [n.to(x.dtype) for n, x in
               zip(torch._foreach_sub(pf, delta), p)]
        return (tree_unflatten(params, new),
                OptState(step, tree_unflatten(params, mu),
                         tree_unflatten(params, nu)))

    def _packed_update(params, state, grads):
        """The same arithmetic on one packed vector a member (under
        vmap): the clip reads each member's own norm."""
        p = tree_leaves(params)
        g = pack(tree_leaves(grads))
        if clip_norm is not None:
            g = g * _clip_scale(torch.linalg.vector_norm(g), clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(b1, stepf)
        b2c = 1 - torch.pow(b2, stepf)
        mu = pack(tree_leaves(state.mu)) * b1 + g * (1 - b1)
        nu = pack(tree_leaves(state.nu)) * b2 + g * g * (1 - b2)
        delta = mu / b1c * lr_t / (torch.sqrt(nu / b2c) + eps)
        pf = pack(p)
        if weight_decay:
            delta = delta + pf * (lr_t * weight_decay)
        return (tree_unflatten(params, unpack(pf - delta, p)),
                OptState(step, tree_unflatten(params, unpack(mu, p)),
                         tree_unflatten(params, unpack(nu, p))))

    return Optimizer(init=init, update=update)


def adamw(lr, *, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def sgd(lr: float | Schedule, *, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        mu = _zeros_state(params)
        return OptState(_step0(params), mu, mu)

    def update(params, state, grads):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = sched(step)
        g = [x.to(torch.float32) for x in tree_leaves(grads)]
        mu = torch._foreach_add(torch._foreach_mul(tree_leaves(state.mu),
                                                   momentum), g)
        p = tree_leaves(params)
        new = [n.to(x.dtype) for n, x in zip(
            torch._foreach_sub([x.to(torch.float32) for x in p],
                               torch._foreach_mul(mu, lr_t)), p)]
        return (tree_unflatten(params, new),
                OptState(step, tree_unflatten(params, mu), state.nu))

    return Optimizer(init=init, update=update)


def ema_update(avg: Params, new: Params, tau: float) -> Params:
    """Polyak averaging for target networks: avg <- (1-tau) avg + tau new.
    ``new`` may hold more entries than ``avg``; only ``avg``'s are read."""
    a = tree_leaves(avg)
    n = tree_leaves(tree_map(lambda _, x: x, avg, new))
    if batched(a):
        out = pack(a) * (1 - tau) + pack(n) * tau
        return tree_unflatten(avg, unpack(out, a))
    return tree_unflatten(avg, torch._foreach_add(
        torch._foreach_mul(a, 1 - tau), torch._foreach_mul(n, tau)))


__all__ = ["OptState", "Optimizer", "adam", "adamw", "batched",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "ema_update", "global_norm", "pack", "sgd", "unpack"]
