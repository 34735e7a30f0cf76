"""Activation sharding constraints (mesh-agnostic model code), as in
``repro.nn.constrain``.

Launch code enters ``activation_sharding(mesh, global_batch)``; layer code
calls ``constrain(x, dims)`` with semantic dim names:

  "batch" -> the data axes, iff that dim equals the global batch and the
             axes divide it
  "model" -> the "model" axis, iff it divides the dim
  "data"  -> the "data" axis, iff it divides the dim (the expert axis of an
             expert-parallel MoE)
  None    -> unconstrained

Where the reference pins a GSPMD sharding (``with_sharding_constraint``),
the port redistributes a ``DTensor`` to the same layout: the spec is the
reference's, and :func:`placements` maps it to one ``Shard``/``Replicate``
a mesh dim.  As GSPMD's constraint holds the cotangent too, the gradient
arriving there is redistributed to the same layout in the backward.  A
plain tensor inside the context is taken as replicated on the mesh
first.  Outside the context every call returns ``x`` itself, so
single-device runs never touch ``torch.distributed``.

This module also holds what the sharding rules (``models.sharding``) and
this context share: the spec type :class:`P`, :func:`axis_sizes` and
:func:`placements`.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys
from typing import Any, Mapping, Optional, Sequence

import torch
from torch.overrides import TorchFunctionMode

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)


class P(tuple):
    """A partition spec: one entry a tensor dim, each None (unsharded), an
    axis name, or a tuple of axis names (outermost first), as the
    reference's ``jax.sharding.PartitionSpec``: ``P(None, "data")``,
    ``P(("pod", "data"), None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` (its ``shape`` is a tuple, its axis
    names ``mesh_dim_names``), of an object whose ``shape`` is such a
    mapping (the reference's ``FakeMesh``), or of the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, tuple(shape)))


def data_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names that axis, else
    ``Replicate()``.  ``("pod", "data")`` on one tensor dim is ``Shard(d)``
    on both mesh dims, pod first, as the mesh orders them."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, part in enumerate(spec):
        for axis in ((part,) if isinstance(part, str) else part or ()):
            owner[axis] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


@contextlib.contextmanager
def activation_sharding(mesh, global_batch: int):
    token = _ACT_CTX.set((mesh, global_batch))
    try:
        yield
    finally:
        _ACT_CTX.reset(token)


def activation_spec(shape: Sequence[int], dims: Sequence[Optional[str]],
                    mesh_axes: Mapping[str, int], batch: int) -> P:
    """The reference's spec for an activation of ``shape`` with semantic
    ``dims`` on a mesh of ``mesh_axes`` ({axis: size}) at global
    ``batch``: each axis used once, each only where it divides."""
    parts: list[Any] = []
    used: set[str] = set()
    for name, size in zip(dims, shape):
        part = None
        if name == "batch":
            axes = data_axes(mesh_axes)
            n = 1
            for a in axes:
                n *= mesh_axes[a]
            if size == batch and size % n == 0 and not (set(axes) & used):
                part = axes if len(axes) > 1 else axes[0]
                used.update(axes)
        elif name in ("model", "data"):
            if size % mesh_axes[name] == 0 and size > 0 and name not in used:
                part = name
                used.add(name)
        parts.append(part)
    return P(*parts)


def _to(x, mesh, pl):
    """``x.redistribute(mesh, pl)``; where the placements change only on
    mesh dims of one chip (whose shard is the whole dim), the local
    tensor is relabelled in place of a collective's fresh copy, so a
    one-chip mesh computes on the very tensors an unsharded run does."""
    from torch.distributed.tensor import DTensor
    pl = list(pl)
    if all(a == b or n == 1 for a, b, n in zip(x.placements, pl,
                                                mesh.shape)):
        if pl == list(x.placements):
            return x
        return DTensor.from_local(x.to_local(), mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return x.redistribute(mesh, pl)


def on_mesh(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated there."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, dims: Sequence[Optional[str]]):
    ctx = _ACT_CTX.get()
    if ctx is None or not hasattr(x, "ndim"):
        return x
    mesh, batch = ctx
    if x.ndim != len(dims):
        return x
    spec = activation_spec(tuple(x.shape), dims, axis_sizes(mesh), batch)
    y = _to(on_mesh(x, mesh), mesh, placements(spec, mesh))
    if torch.is_grad_enabled() and y.requires_grad:
        y = _PinGrad.apply(y)     # the cotangent takes the same layout
    return y


def gathered(w):
    """A parameter as its layer uses it: a DTensor's FSDP shard (any
    mesh dim but "model") all-gathered and its "model" (TP) shard kept,
    as FSDP gathers a layer's weights before the layer runs; in the
    backward the gradient goes back to the shard (a reduce-scatter).  Any
    other tensor is returned itself."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and name != "model" else p
          for name, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return _to(w, w.device_mesh, pl)


def reduced(y):
    """A DTensor matmul result with its partial sums reduced (a
    row-parallel projection's all-reduce, as in Megatron's tensor
    parallelism): left partial, DTensor carries the sums into the next
    ops and picks layouts that shard the sequence instead.  Any other
    tensor is returned itself."""
    if not is_dtensor(y) or not any(p.is_partial() for p in y.placements):
        return y
    from torch.distributed.tensor import Replicate
    return _to(y, y.device_mesh, [
        Replicate() if p.is_partial() else p for p in y.placements])


def constrain_act(x):
    """Batch-major hidden state: dim0 = batch, rest unconstrained."""
    ctx = _ACT_CTX.get()
    if ctx is None or not hasattr(x, "ndim") or x.ndim == 0:
        return x
    return constrain(x, ("batch",) + (None,) * (x.ndim - 1))


@contextlib.contextmanager
def _restored(ctx):
    token = _ACT_CTX.set(ctx)
    try:
        if ctx is None:
            yield
        else:
            with RegatherReshapes():
                yield
    finally:
        _ACT_CTX.reset(token)


def on_local_tensors():
    """A context in which layer code runs on one chip's plain local
    tensors (inside ``local_map``): no activation context, so every
    ``constrain`` returns its argument."""
    return _restored(None)


def checkpoint_context_fn():
    """A ``context_fn`` for ``torch.utils.checkpoint``: its recompute runs
    under the activation context of the forward (and its
    :class:`RegatherReshapes`), which autograd runs in the backward pass,
    on a device thread of its own on the card, where neither a context
    variable nor a function mode of the caller's thread reaches."""
    ctx = _ACT_CTX.get()
    return lambda: (contextlib.nullcontext(), _restored(ctx))


def _reshaped(shape, func, args, kwargs) -> Optional[tuple]:
    """The shape a reshape ``func(x, *args, **kwargs)`` of an ``x`` of
    ``shape`` gives, or None where the call is not a reshape (a view to
    another dtype)."""
    shape = tuple(shape)
    if func in (torch.Tensor.unflatten, torch.unflatten):
        dim, sizes = (list(args) + [kwargs.get("dim"), kwargs.get("sizes")]
                      )[:2]
        dim %= len(shape)
        new = list(sizes)
        if -1 in new:
            known = math.prod(s for s in new if s != -1)
            new[new.index(-1)] = shape[dim] // known
        return shape[:dim] + tuple(new) + shape[dim + 1:]
    new = args[0] if len(args) == 1 else args
    new = kwargs.get("shape", kwargs.get("size", new))
    if isinstance(new, int):
        new = (new,)
    if not all(isinstance(s, int) for s in new):
        return None
    new = list(new)
    if -1 in new:
        known = math.prod(s for s in new if s != -1)
        new[new.index(-1)] = math.prod(shape) // known
    return tuple(new)


def _changed_dims(old, new) -> range:
    """The dims of shape ``old`` that a reshape to ``new`` splits or
    merges: all but the common leading and trailing ones."""
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while (hi < min(len(old), len(new)) - lo
           and old[len(old) - 1 - hi] == new[len(new) - 1 - hi]):
        hi += 1
    return range(lo, len(old) - hi)


class _PinGrad(torch.autograd.Function):
    """Identity whose backward gives the gradient the placements of the
    forward value, as a GSPMD sharding annotation holds the cotangent too:
    the backward of a reshape then inverts the reshape the forward made."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate
        # a partial sum's cotangent is the same on every chip
        ctx.mesh = y.device_mesh
        ctx.placements = [Replicate() if p.is_partial() else p
                          for p in y.placements]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


class RegatherReshapes(TorchFunctionMode):
    """A reshape of a DTensor that would split a shard (a head dim that
    the model axis does not divide, a token axis regrouped across the
    batch shards) first regathers the dims it changes, as GSPMD reshards
    around such a reshape by itself; DTensor refuses it.  Under autograd
    the result's gradient is pinned to the result's placements
    (:class:`_PinGrad`), so the backward's reshape is the forward's
    inverse."""

    _RESHAPES = {torch.Tensor.reshape, torch.Tensor.view, torch.reshape,
                 torch.Tensor.unflatten, torch.unflatten}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._RESHAPES or not is_dtensor(args[0]):
            return func(*args, **kwargs)
        x = args[0]
        try:
            y = func(*args, **kwargs)
        except RuntimeError:
            from torch.distributed.tensor import Replicate
            new = _reshaped(x.shape, func, args[1:], kwargs)
            if new is None:
                raise
            changed = _changed_dims(tuple(x.shape), new)
            pl = [Replicate() if p.is_shard() and p.dim in changed else p
                  for p in x.placements]
            if pl == list(x.placements):
                raise
            x = x.redistribute(x.device_mesh, pl)
            y = func(x, *args[1:], **kwargs)
        if torch.is_grad_enabled() and x.requires_grad:
            y = _PinGrad.apply(y)
        return y


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing
    ``torch.distributed.tensor`` where nothing has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


__all__ = ["P", "activation_sharding", "activation_spec", "axis_sizes",
           "checkpoint_context_fn", "constrain", "constrain_act",
           "data_axes", "gathered", "is_dtensor", "on_local_tensors",
           "on_mesh", "placements", "reduced", "RegatherReshapes"]
