"""Carry the reference's parameters into the port.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a parity check never re-initialises: it converts the reference's
parameter tree.  Both packages keep conv kernels HWIO and dense kernels
``(in, out)``, and a decoder's stacked ``"scan"`` subtree keeps its
leading layer axis in both, so the conversion is a copy, leaf by leaf,
with no transposition.  bfloat16 leaves are carried bit for bit.
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
    {"kernel", "bias"}}}``, a head's ``{"mlp": {"fc0": ...}}``, or a
    ``DecoderModel.init`` tree.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.array(x, copy=True)
        if a.dtype.name == "bfloat16":
            # numpy holds bfloat16 as an extension type torch cannot read:
            # move the 16-bit patterns and reinterpret them
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)


__all__ = ["params_from_jax"]
