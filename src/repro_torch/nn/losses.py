"""Losses, as in ``repro.nn.losses``.

The reference keeps the vocab axis sharded under GSPMD and takes the gold
logit with a one-hot contraction; on one card the port takes it with a
gather, which reads the same element (the contraction adds exact zeros to
it), and never builds a (B, S, V) one-hot.
"""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits, targets):
    """logits: (B, S, V) (any float dtype); targets: (B, S) integer.

    Returns per-token CE (B, S) in float32: a log-sum-exp in float32 with
    its max a constant to autograd, less the gold logit.
    """
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    logz = m[..., 0] + torch.log(torch.sum(torch.exp(lf - m), dim=-1))
    gold = lf.gather(-1, targets.long()[..., None])[..., 0]
    return logz - gold


__all__ = ["softmax_cross_entropy"]
