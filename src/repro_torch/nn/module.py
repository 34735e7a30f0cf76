"""Parameter initialisers drawing from an explicit ``torch.Generator``.

Parameters are plain nested dicts of tensors, as in the reference
(``repro.nn.module``).  Where the reference splits a ``jax.random`` key
per tensor (``KeyGen``), the port draws every tensor in turn from one
generator.  Initialisers draw on the generator's device (the CPU for a
``torch.Generator()``) so that a seed gives the same parameters whatever
device they are moved to afterwards.  The two frameworks' generators give
different numbers from the same seed; parity tests convert the reference's
parameters instead (``repro_torch.convert``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator

import torch
from torch.overrides import TorchFunctionMode

Initializer = Callable[[torch.Generator, tuple, torch.dtype], torch.Tensor]


def _normal(gen, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype`` on the generator's device.
    f32 is drawn and scaled in place.  A narrower dtype is drawn straight
    into its own storage (``normal_`` computes each value in f32 and
    rounds it once), so a bf16 leaf never holds an f32 copy of itself:
    drawing a 256,000 x 4,096 embedding costs its own bytes alone.  Its
    values need not equal an f32 draw's cast down: the generator's stream
    is spent differently."""
    if dtype == torch.float32:
        return torch.randn(shape, generator=gen, device=gen.device).mul_(std)
    return torch.empty(shape, dtype=dtype, device=gen.device).normal_(
        0.0, std, generator=gen)


def normal_init(stddev: float = 0.02) -> Initializer:
    """Normal with a fixed standard deviation (the embedding's)."""

    def init(gen, shape, dtype=torch.float32):
        return _normal(gen, shape, stddev, dtype)

    return init


def fan_in_init(scale: float = 1.0, fan_axis: int = 0) -> Initializer:
    """LeCun-style fan-in scaled normal (default for projection matrices)."""

    def init(gen, shape, dtype=torch.float32):
        fan_in = shape[fan_axis] if shape else 1
        return _normal(gen, shape, scale / math.sqrt(max(fan_in, 1)), dtype)

    return init


def orthogonal_init(scale: float = 1.0) -> Initializer:
    def init(gen, shape, dtype=torch.float32):
        x = torch.empty(shape, device=gen.device)
        torch.nn.init.orthogonal_(x, gain=scale, generator=gen)
        return x.to(dtype)

    return init


class _NoDraw(TorchFunctionMode):
    """Every tensor a ``torch.*`` factory makes lands on ``meta`` and
    every ``generator`` is dropped: an initialiser run under this mode
    draws nothing and allocates nothing, and returns leaves of the shapes
    and dtypes it would return."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "generator" in kwargs:
            kwargs.pop("generator")
            if func is torch.nn.init.orthogonal_:
                return args[0]
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_draw():
    """Run initialisers on ``meta`` without drawing from their generator
    (``DecoderModel.init(..., device="meta")`` enters it itself)."""
    with _NoDraw():
        yield


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict of tensors (leaf by leaf
    across ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves`` order: keys
    sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """The tree shaped like ``like`` with ``leaves`` (in ``tree_leaves``
    order) at its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return next(it)

    return build(like)


# ---------------------------------------------------------------------------
# Pytree helpers (``repro.nn.module``'s)
# ---------------------------------------------------------------------------

def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def tree_paths(params, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield ('a/b/c', leaf) pairs for a nested dict (lists and tuples
    index by position), in ``jax.tree_util.tree_flatten_with_path``'s
    order and with its key strings: checkpoints key on them."""
    if isinstance(params, dict):
        items = ((str(k), params[k]) for k in sorted(params))
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        yield prefix, params
        return
    for k, v in items:
        yield from tree_paths(v, f"{prefix}/{k}" if prefix else k)


def cast_tree(params, dtype):
    """Every floating-point leaf cast to ``dtype``; the others kept."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


__all__ = ["Initializer", "cast_tree", "fan_in_init", "no_draw",
           "normal_init", "orthogonal_init", "param_bytes", "param_count",
           "tree_leaves", "tree_map", "tree_paths", "tree_unflatten"]
