"""Carry the reference's parameters into the port.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so a parity check never re-initialises: it converts the reference's
parameter tree.  Both packages keep conv kernels HWIO and dense kernels
``(in, out)``, and a decoder's stacked ``"scan"`` subtree (Whisper's
``"enc_scan"`` and ``"dec_scan"``) keeps its leading layer axis in both,
so the conversion is a copy, leaf by leaf, with no transposition.  bfloat16 leaves are carried bit for bit.
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
    {"kernel", "bias"}}}``, a head's ``{"mlp": {"fc0": ...}}``, a
    ``DecoderModel.init`` tree or a ``WhisperModel.init`` tree.
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


def train_state_from_jax(state, device: DeviceLike = None):
    """A reference ``TrainState(params, target, OptState(step, mu, nu))``
    -> the port's, on ``device``: every tree through
    :func:`params_from_jax` (a 0-d leaf such as ``log_alpha`` stays 0-d),
    the step as a 0-d int32 tensor.  An update can then start from the
    reference's own optimizer state."""
    from repro_torch.rl.agent import TrainState
    from repro_torch.train.optimizer import OptState
    params, target, opt = state
    step = params_from_jax(np.asarray(opt.step, dtype=np.int32), device)
    return TrainState(params_from_jax(params, device),
                      params_from_jax(target, device),
                      OptState(step, params_from_jax(opt.mu, device),
                               params_from_jax(opt.nu, device)))


def stacked_train_state_from_jax(state, device: DeviceLike = None):
    """A reference population's member-stacked ``TrainState`` (a leading
    ``(P,)`` axis on every leaf, the step included, as its engine's carry
    holds it) -> the port's stacked state, the layout the batched lanes of
    ``repro_torch.rl.population`` carry: :func:`train_state_from_jax` leaf
    by leaf, after checking that every leaf has the same member axis."""
    from repro_torch.nn.module import tree_leaves
    out = train_state_from_jax(state, device)
    params, target, opt = out
    leaves = [opt.step] + [x for t in (params, target, opt.mu, opt.nu)
                           for x in tree_leaves(t)]
    sizes = {x.shape[0] if x.dim() else None for x in leaves}
    if len(sizes) != 1 or None in sizes:
        raise ValueError(f"not a member-stacked TrainState: leading sizes "
                         f"{sorted(sizes, key=str)}")
    return out


__all__ = ["params_from_jax", "stacked_train_state_from_jax",
           "train_state_from_jax"]
