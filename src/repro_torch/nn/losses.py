"""Losses, as in ``repro.nn.losses``.

The reference keeps the vocab axis sharded and takes the gold logit with
a one-hot contraction, so no op needs the whole vocab on one chip.  The
port does the same on DTensor logits (the sharded steps), each chip on
its own vocab block (:func:`_gold_sharded`), and elsewhere takes the gold
logit with a gather, which reads the same element (the contraction adds
exact zeros to it) and never builds a (B, S, V) one-hot.
"""
from __future__ import annotations

import torch

from repro_torch.nn.constrain import (activation_spec, axis_sizes, constrain,
                                      is_dtensor, placements, reduced)


def softmax_cross_entropy(logits, targets):
    """logits: (B, S, V) (any float dtype); targets: (B, S) integer.

    Returns per-token CE (B, S) in float32: a log-sum-exp in float32 with
    its max a constant to autograd, less the gold logit.
    """
    logits = constrain(logits, ("batch", None, "model"))
    lf = logits.float()
    if is_dtensor(lf):
        logz = _LogSumExp.apply(lf)
        gold = _gold_sharded(lf, targets)
    else:
        logz = _logsumexp(lf)[0]
        gold = lf.gather(-1, targets.long()[..., None])[..., 0]
    return logz - gold


def _logsumexp(lf):
    """(logz, e, s): the log-sum-exp over the last dim with its max ``m``
    a constant, ``e = exp(lf - m)`` and ``s = e.sum(-1)``."""
    m = lf.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(lf - m)
    s = reduced(torch.sum(e, dim=-1))    # summed over the vocab shards
    return m[..., 0] + torch.log(s), e, s


class _LogSumExp(torch.autograd.Function):
    """:func:`_logsumexp` of a vocab-sharded DTensor with its backward
    written out: ``(g / s) * e``, the very ops autograd runs for the
    unsharded loss, none of them a reduction.  Left to autograd, the
    backward of the sum over the sharded vocab came out 4x too large on a
    2x2 mesh under torch 2.11 (right under 2.13)."""

    @staticmethod
    def forward(ctx, lf):
        logz, e, s = _logsumexp(lf)
        ctx.save_for_backward(e, s)
        return logz

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        return (g / s)[..., None] * e


def _gold_sharded(lf, targets):
    """The gold logits of DTensor ``lf`` (B, S, V): each chip contracts
    its vocab block with a one-hot of the targets built for that block
    (``local_map``; batch over the data axes, vocab over "model"), and
    the partial sums add up over "model" (the vocab-parallel
    cross-entropy).  The one-hot is never whole on a chip."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = lf.device_mesh
    spec = activation_spec(tuple(lf.shape), ("batch", None, "model"),
                           axis_sizes(mesh), lf.shape[0])
    lf_pl = placements(spec, mesh)
    t_pl = placements((spec[0], None), mesh)
    split = spec[2] == "model"

    def local(lf, t):
        V = lf.shape[-1]
        lo = mesh.get_local_rank("model") * V if split else 0
        iota = torch.arange(lo, lo + V, device=lf.device)
        onehot = (t.long()[..., None] == iota).to(lf.dtype)
        return (lf * onehot).sum(-1)     # the one term that is not 0

    out_pl = [Partial() if split and name == "model" else p
              for name, p in zip(mesh.mesh_dim_names, t_pl)]
    return local_map(local, out_placements=out_pl,
                     in_placements=(lf_pl, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(lf, targets)


__all__ = ["softmax_cross_entropy"]
