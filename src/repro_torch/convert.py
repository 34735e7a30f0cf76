"""Carry the reference's parameters into the port.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a parity check never re-initialises: it converts the reference's
parameter tree.  Both packages keep conv kernels HWIO and dense kernels
``(in, out)``, so the conversion is a copy, leaf by leaf, with no
transposition.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def params_from_jax(tree, device: DeviceLike = None):
    """A nested dict of arrays -> the same dict of tensors on ``device``.

    ``tree`` is the reference's parameter pytree with numpy-convertible
    leaves (``jax.Array`` or ``np.ndarray``), e.g.
    ``{"edge": {"layer0": {"kernel", "bias"}, ...}, "server": {"proj":
    {"kernel", "bias"}}}`` or a head's ``{"mlp": {"fc0": ...}}``.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


__all__ = ["params_from_jax"]
