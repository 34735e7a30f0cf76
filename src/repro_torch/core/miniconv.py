"""MiniConv: small convolutional encoders under the paper's shader budget.

The port of ``repro.core.miniconv``.  The constraint model is the paper's
(§3) and is kept verbatim:

* one pass writes exactly 4 output channels (RGBA texture);
* a pass may bind at most 8 input textures => C_in <= 32 per pass;
* a pass has a finite per-pixel sampling budget (64 samples in the paper's
  Pi Zero 2 W deployment): ``k_h * k_w * ceil(C_in / 4) <= 64``.

:func:`miniconv_apply` runs an encoder through one of the execution tiers
of ``repro_torch.core.backends``: eager PyTorch (``xla``, the training
path), the per-pass CUDA kernel (``reference``), the per-layer CUDA kernel
(``grouped``) or the fused whole-encoder CUDA kernel (``fused``,
``fused+head``, and ``fused+stream``, its persistent streamed form).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import tracing
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import conv2d, conv2d_init


# ---------------------------------------------------------------------------
# Constraint model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShaderBudget:
    """Embedded-GPU constraints a MiniConv pass must respect (paper §3)."""

    max_textures: int = 8        # bound input textures per pass
    channels_per_texture: int = 4  # RGBA packing
    max_samples: int = 64        # texture samples per output pixel
    out_channels_per_pass: int = 4  # one RGBA render target

    @property
    def max_in_channels(self) -> int:
        return self.max_textures * self.channels_per_texture

    def samples(self, kernel: int, c_in: int) -> int:
        textures = math.ceil(c_in / self.channels_per_texture)
        return kernel * kernel * textures

    def check_pass(self, kernel: int, c_in: int) -> list[str]:
        errs = []
        if c_in > self.max_in_channels:
            errs.append(
                f"pass reads {c_in} channels > {self.max_in_channels} "
                f"({self.max_textures} textures x {self.channels_per_texture})")
        s = self.samples(kernel, c_in)
        if s > self.max_samples:
            errs.append(
                f"pass needs {s} samples/pixel "
                f"({kernel}x{kernel} x {math.ceil(c_in / 4)} textures) "
                f"> budget {self.max_samples}")
        return errs


PI_ZERO_BUDGET = ShaderBudget()  # the paper's Raspberry Pi Zero 2 W numbers


# ---------------------------------------------------------------------------
# Encoder specification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One conv layer = ceil(c_out/4) shader passes over the same input."""

    kernel: int
    stride: int
    c_in: int
    c_out: int
    activation: str = "relu"    # relu | sigmoid | linear

    @property
    def n_passes(self) -> int:
        return math.ceil(self.c_out / 4)


@dataclasses.dataclass(frozen=True)
class MiniConvSpec:
    layers: tuple[LayerSpec, ...]
    budget: ShaderBudget = PI_ZERO_BUDGET

    @property
    def k_out(self) -> int:
        return self.layers[-1].c_out

    @property
    def n_stride2(self) -> int:
        return sum(1 for l in self.layers if l.stride == 2)

    @property
    def total_passes(self) -> int:
        from repro_torch.core.passplan import count_passes  # lazy: cycle
        return count_passes(self)

    def validate(self) -> None:
        errs: list[str] = []
        for i, l in enumerate(self.layers):
            for e in self.budget.check_pass(l.kernel, l.c_in):
                errs.append(f"layer {i}: {e}")
            if i and l.c_in != self.layers[i - 1].c_out:
                errs.append(f"layer {i}: c_in {l.c_in} != previous c_out "
                            f"{self.layers[i - 1].c_out}")
        if errs:
            raise ValueError("MiniConvSpec violates shader budget:\n  " +
                             "\n  ".join(errs))

    def plan(self, h: int, w: Optional[int] = None):
        """Lower this spec onto an input size (see ``core.passplan``)."""
        from repro_torch.core.passplan import build_pass_plan  # lazy: cycle
        return build_pass_plan(self, h, w)

    def out_spatial(self, x: int) -> int:
        from repro_torch.core.passplan import out_spatial_chain
        return out_spatial_chain(x, (l.stride for l in self.layers))

    def feature_bytes(self, x: int) -> int:
        """Transmitted feature bytes for an X-by-X input (uint8 wire)."""
        return self.plan(x).feature_bytes

    def flops_per_frame(self, x: int) -> int:
        return self.plan(x).flops_per_frame


def standard_spec(c_in: int = 12, k: int = 4, *, n_stride2: int = 3,
                  hidden: int = 16,
                  budget: ShaderBudget = PI_ZERO_BUDGET) -> MiniConvSpec:
    """The encoder family used in the paper's experiments.

    Defaults give the K=4, n=3 Pi-Zero configuration: three stride-2 layers,
    4x4 then 3x3 kernels, every pass within the 64-sample budget:
      4x4 x ceil(12/4)=3 textures = 48 samples; 3x3 x 4 = 36 samples.
    """
    layers = [LayerSpec(4, 2, c_in, hidden)]
    for _ in range(n_stride2 - 2):
        layers.append(LayerSpec(3, 2, hidden, hidden))
    layers.append(LayerSpec(3, 2, hidden, k, activation="sigmoid"))
    spec = MiniConvSpec(tuple(layers), budget)
    spec.validate()
    return spec


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------

def miniconv_init(gen: torch.Generator, spec: MiniConvSpec, *,
                  dtype=torch.float32, device: DeviceLike = None):
    dev = resolve_device(device)
    return {f"layer{i}": conv2d_init(gen, l.kernel, l.kernel, l.c_in,
                                     l.c_out, dtype=dtype, device=dev)
            for i, l in enumerate(spec.layers)}


_ACTS: dict[str, Callable] = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}


def miniconv_apply(params, spec: MiniConvSpec, x, *, use_kernel=False,
                   tile_h: int = 8, plan=None, head=None,
                   head_act: str = "relu", stream_chunk=None):
    """x: (B, H, W, C_in) float in [0,1] -> (B, H', W', K).

    Execution modes (``use_kernel``, resolved by ``core.backends``):

    * ``False`` / ``"xla"``        — eager PyTorch SAME convs (training).
    * ``True`` / ``"reference"``   — one per-pass CUDA kernel launch per
      :class:`~repro_torch.core.passplan.ShaderPass` (the shader oracle).
    * ``"grouped"``                — one CUDA kernel launch per layer, all
      output groups together; equal to ``reference`` bit for bit.
    * ``"fused"`` / ``"fused+head"`` — the whole PassPlan as ONE CUDA
      kernel launch per batch.

    ``stream_chunk`` (fused tiers only) runs the batch through the
    persistent streamed kernel with ``stream_chunk`` frames in flight
    (:func:`~repro_torch.kernels.miniconv_pass.miniconv_encoder_stream`).
    ``use_kernel="fused+stream"`` selects streaming with ``stream_chunk``
    defaulting to the plan's ``max_safe_batch``; a batch within one chunk
    falls through to the plain fused launch.  Results are bitwise equal
    either way.

    ``head`` (``{"kernel": (F, D)[, "bias": (D,)]}`` or ``(w, b)``) appends
    the flatten + dense projection and makes the return value
    ``(features, head_act(flat @ w + b))``.  In ``fused`` mode the
    projection is the kernel's epilogue.  ``tile_h`` is accepted for the
    reference's signature and does not change the result: the CUDA kernel
    picks its own halo tiles (``PassPlan.tile_plan``).  On CPU tensors
    every tier computes with the plain PyTorch versions of its kernels.
    """
    with tracing.span("encoder"):
        from repro_torch.core.backends import get_backend  # lazy: avoids cycle
        backend = get_backend(use_kernel)
        mode = backend.mode
        hw = hb = None
        if head is not None:
            hw, hb = ((head["kernel"], head.get("bias"))
                      if isinstance(head, dict) else head)
        if mode == "fused":
            from repro_torch.kernels.miniconv_pass import (
                miniconv_encoder, miniconv_encoder_stream)
            if plan is None:
                plan = spec.plan(x.shape[1], x.shape[2])
            elif (plan.in_h, plan.in_w) != (x.shape[1], x.shape[2]):
                raise ValueError(
                    f"plan was built for {(plan.in_h, plan.in_w)} input but "
                    f"got {tuple(x.shape[1:3])}; rebuild with spec.plan(h, w)")
            n = len(spec.layers)
            ws = [params[f"layer{i}"]["kernel"] for i in range(n)]
            bs = [params[f"layer{i}"]["bias"] for i in range(n)]
            if backend.streamed and stream_chunk is None:
                stream_chunk = plan.max_safe_batch()
            if stream_chunk is not None:
                return miniconv_encoder_stream(x, ws, bs, plan,
                                               chunk_b=stream_chunk,
                                               tile_h=tile_h, head_w=hw,
                                               head_b=hb, head_act=head_act)
            return miniconv_encoder(x, ws, bs, plan, tile_h=tile_h, head_w=hw,
                                    head_b=hb, head_act=head_act)
        if mode in ("per_pass", "grouped"):
            from repro_torch.kernels.ops import miniconv_layer  # lazy: cycles
        for i, l in enumerate(spec.layers):
            p = params[f"layer{i}"]
            if mode == "xla":
                x = conv2d(p, x, stride=l.stride, padding="SAME")
            else:
                x = miniconv_layer(x, p["kernel"], p["bias"], stride=l.stride,
                                   fused_groups=(mode == "grouped"))
            x = _ACTS[l.activation](x)
        if head is not None:
            z = x.reshape(x.shape[0], -1) @ hw
            if hb is not None:
                z = z + hb
            return x, _ACTS[head_act](z)
        return x


def miniconv_feature_shape(spec: MiniConvSpec, h: int, w: int) -> tuple:
    """(H', W', C) of the encoder's feature map for an (h, w) input."""
    return spec.plan(h, w).feature_shape


__all__ = ["LayerSpec", "MiniConvSpec", "PI_ZERO_BUDGET", "ShaderBudget",
           "miniconv_feature_shape",
           "miniconv_apply", "miniconv_init", "standard_spec"]
