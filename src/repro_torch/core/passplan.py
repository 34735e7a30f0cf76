"""Pass-plan IR: the compiled form of a MiniConv encoder.

The port of ``repro.core.passplan``.  The paper (§3) compiles a small conv
encoder into an ordered sequence of fragment-shader passes, each subject to
the embedded-GPU constraint model:

* a pass renders ONE RGBA target      -> ``ShaderPass.out_lo/out_hi``
  (<= 4 output channels);
* a pass binds <= 8 input textures    -> ``ShaderPass.texture_bindings``
  (4 packed channels per texture, so C_in <= 32);
* a pass has a per-pixel sampling
  budget (64 on the Pi Zero 2 W)      -> ``ShaderPass.samples``
  = k_h * k_w * ceil(C_in / 4).

:class:`PassPlan` lowers a :class:`~repro_torch.core.miniconv.MiniConvSpec`
plus a concrete input size into per-layer records (:class:`LayerPlan`) and
a flat ordered pass list (:class:`ShaderPass`), budget-checked at build
time.  The shape, budget, FLOP and byte arithmetic is the reference's, bit
for bit.

What differs is the residency model.  The reference models the TPU
kernel's 16 MiB VMEM; the port models its own CUDA kernel
(``kernels/csrc/miniconv_encoder.cu``): one thread block per frame, whose
layer intermediates are staged in the block's shared memory when they fit
(:attr:`PassPlan.staging` is ``"shared"``) and otherwise in a per-frame
global workspace that stays resident in the card's L2 (``"global"``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.core.miniconv import MiniConvSpec, ShaderBudget, PI_ZERO_BUDGET


# ---------------------------------------------------------------------------
# Spatial primitives (THE ceil rule — everything else derives from these)
# ---------------------------------------------------------------------------

def out_size(x: int, stride: int) -> int:
    """Output side of a SAME conv: ceil(x / stride)."""
    return -(-x // stride)


def out_spatial_chain(x: int, strides: Iterable[int]) -> int:
    """Spatial side after a chain of SAME convs with the given strides."""
    for s in strides:
        x = out_size(x, s)
    return x


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(lo, hi) zero padding so a VALID conv reproduces XLA's SAME conv."""
    total = max((out_size(size, stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def count_passes(spec: MiniConvSpec) -> int:
    """Total shader passes for a spec (spatial-size independent)."""
    return sum(-(-l.c_out // 4) for l in spec.layers)


def _round4(c: int) -> int:
    return -(-c // 4) * 4


# Residency model of the fused CUDA kernel on an H100.
# Dynamic shared memory one thread block may use (after raising
# cudaFuncAttributeMaxDynamicSharedMemorySize).
SMEM_LIMIT = 232_448
# The card's L2.  Global-workspace staging keeps the intermediates of this
# many bytes of frames L2-resident; more frames still run correctly, from
# device memory.
WORKSPACE_LIMIT = 50 * 1024 * 1024
# Frames one launch can take: one block per frame on the grid's x axis.
MAX_GRID_FRAMES = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# IR records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One conv layer lowered onto a concrete input size."""

    index: int
    kernel: int
    stride: int
    activation: str
    c_in: int
    c_out: int
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    pad_top: int
    pad_bottom: int
    pad_left: int
    pad_right: int

    @property
    def n_groups(self) -> int:
        return -(-self.c_out // 4)

    @property
    def c_in_pad(self) -> int:
        return _round4(self.c_in)

    @property
    def c_out_pad(self) -> int:
        return _round4(self.c_out)

    @property
    def padded_in_h(self) -> int:
        return self.in_h + self.pad_top + self.pad_bottom

    @property
    def padded_in_w(self) -> int:
        return self.in_w + self.pad_left + self.pad_right

    @property
    def out_elems(self) -> int:
        return self.out_h * self.out_w * self.c_out

    @property
    def flops(self) -> int:
        return (2 * self.out_h * self.out_w * self.kernel * self.kernel
                * self.c_in * self.c_out)


@dataclasses.dataclass(frozen=True)
class ShaderPass:
    """One fragment-shader pass: the unit the paper's compiler emits."""

    layer: int                  # owning layer index
    group: int                  # output-group index within the layer
    kernel: int
    stride: int
    activation: str
    c_in: int
    out_lo: int                 # output channel slice [out_lo, out_hi)
    out_hi: int                 # out_hi - out_lo <= 4 (one RGBA target)
    out_h: int
    out_w: int

    @property
    def texture_bindings(self) -> tuple[tuple[int, int], ...]:
        """Input channel ranges packed 4-per-texture, as bound by the pass."""
        return tuple((lo, min(lo + 4, self.c_in))
                     for lo in range(0, self.c_in, 4))

    @property
    def in_textures(self) -> int:
        return len(self.texture_bindings)

    @property
    def samples(self) -> int:
        """Texture samples per output pixel (the paper's budgeted quantity)."""
        return self.kernel * self.kernel * self.in_textures

    @property
    def flops(self) -> int:
        return (2 * self.out_h * self.out_w * self.kernel * self.kernel
                * self.c_in * (self.out_hi - self.out_lo))


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """The server-side linear projection fused into the encoder epilogue.

    ``in_dim`` is the flattened feature count of the owning
    :class:`PassPlan`, validated against it at build time.
    """

    in_dim: int
    out_dim: int
    activation: str = "relu"

    @property
    def flops(self) -> int:
        return 2 * self.in_dim * self.out_dim

    @property
    def param_bytes(self) -> int:
        return 4 * (self.in_dim + 1) * self.out_dim


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """An ordered, budget-checked shader-pass schedule for one input size."""

    spec: MiniConvSpec
    in_h: int
    in_w: int
    layers: tuple[LayerPlan, ...]
    passes: tuple[ShaderPass, ...]
    budget: ShaderBudget = PI_ZERO_BUDGET

    # ---- derived truths ---------------------------------------------------
    @property
    def out_h(self) -> int:
        return self.layers[-1].out_h

    @property
    def out_w(self) -> int:
        return self.layers[-1].out_w

    @property
    def k_out(self) -> int:
        return self.layers[-1].c_out

    @property
    def feature_shape(self) -> tuple[int, int, int]:
        return (self.out_h, self.out_w, self.k_out)

    @property
    def total_passes(self) -> int:
        return len(self.passes)

    @property
    def feature_bytes(self) -> int:
        """Bytes of the transmitted K-channel feature map (uint8 wire)."""
        return self.out_h * self.out_w * self.k_out

    @property
    def flat_features(self) -> int:
        """Flattened feature count — the fused head's input width."""
        return self.out_h * self.out_w * self.k_out

    @property
    def flops_per_frame(self) -> int:
        return sum(p.flops for p in self.passes)

    def head(self, out_dim: int, activation: str = "relu") -> HeadPlan:
        """Plan the fused projection epilogue for this feature shape."""
        if out_dim <= 0:
            raise ValueError(f"head out_dim must be positive, got {out_dim}")
        return HeadPlan(in_dim=self.flat_features, out_dim=out_dim,
                        activation=activation)

    def flops_per_batch(self, batch: int,
                        head: Optional[HeadPlan] = None) -> int:
        """FLOPs of one fused launch over a ``batch``-frame micro-batch."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        per_frame = self.flops_per_frame
        if head is not None:
            if head.in_dim != self.flat_features:
                raise ValueError(
                    f"head.in_dim {head.in_dim} != plan.flat_features "
                    f"{self.flat_features}")
            per_frame += head.flops
        return batch * per_frame

    @property
    def max_pass_samples(self) -> int:
        return max(p.samples for p in self.passes)

    # ---- residency of the fused CUDA kernel --------------------------------
    @property
    def staging_floats(self) -> tuple[int, int]:
        """Floats of the two ping-pong buffers that hold one frame's layer
        intermediates: layers 0, 2, 4, ... write the first, layers 1, 3,
        ... the second, and the last layer writes the output.  Each is
        rounded up to 4 floats so both start 16-byte aligned."""
        sizes = [0, 0]
        for l in self.layers[:-1]:
            sizes[l.index % 2] = max(sizes[l.index % 2], _round4(l.out_elems))
        return sizes[0], sizes[1]

    @property
    def smem_bytes(self) -> int:
        """Bytes of one frame's staged intermediates."""
        return 4 * sum(self.staging_floats)

    @property
    def staging(self) -> str:
        """Where the fused kernel stages intermediates: ``"shared"`` when
        one frame's fit one block's shared memory, else ``"global"``."""
        return "shared" if self.smem_bytes <= SMEM_LIMIT else "global"

    def workspace_bytes(self, batch: int = 1) -> int:
        """Global workspace of one fused launch over ``batch`` frames."""
        return 0 if self.staging == "shared" else batch * self.smem_bytes

    def max_safe_batch(self) -> int:
        """Frames per fused launch as limited by the workspace: the grid's
        limit when intermediates stay in shared memory, else the frames
        whose workspace fits the L2 (at least 1: more still run, from
        device memory)."""
        if self.staging == "shared":
            return MAX_GRID_FRAMES
        return max(1, WORKSPACE_LIMIT // self.smem_bytes)

    def validate(self) -> None:
        errs: list[str] = []
        for p in self.passes:
            for e in self.budget.check_pass(p.kernel, p.c_in):
                errs.append(f"layer {p.layer} pass {p.group}: {e}")
        if errs:
            raise ValueError("PassPlan violates shader budget:\n  " +
                             "\n  ".join(errs))


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

def build_pass_plan(spec: MiniConvSpec, h: int, w: Optional[int] = None, *,
                    validate: bool = True) -> PassPlan:
    """Lower ``spec`` applied to an (h, w) input into a :class:`PassPlan`.

    Raises ``ValueError`` at build time if any emitted pass exceeds the
    spec's :class:`ShaderBudget` — the kernel layer can assume every plan it
    receives is deployable.
    """
    w = h if w is None else w
    layers: list[LayerPlan] = []
    passes: list[ShaderPass] = []
    cur_h, cur_w = h, w
    for i, l in enumerate(spec.layers):
        oh, ow = out_size(cur_h, l.stride), out_size(cur_w, l.stride)
        pt, pb = same_pads(cur_h, l.kernel, l.stride)
        pl_, pr = same_pads(cur_w, l.kernel, l.stride)
        layers.append(LayerPlan(index=i, kernel=l.kernel, stride=l.stride,
                                activation=l.activation, c_in=l.c_in,
                                c_out=l.c_out, in_h=cur_h, in_w=cur_w,
                                out_h=oh, out_w=ow, pad_top=pt, pad_bottom=pb,
                                pad_left=pl_, pad_right=pr))
        for g, lo in enumerate(range(0, l.c_out, 4)):
            passes.append(ShaderPass(layer=i, group=g, kernel=l.kernel,
                                     stride=l.stride, activation=l.activation,
                                     c_in=l.c_in, out_lo=lo,
                                     out_hi=min(lo + 4, l.c_out),
                                     out_h=oh, out_w=ow))
        cur_h, cur_w = oh, ow
    plan = PassPlan(spec=spec, in_h=h, in_w=w, layers=tuple(layers),
                    passes=tuple(passes), budget=spec.budget)
    if validate:
        plan.validate()
    return plan


__all__ = ["HeadPlan", "LayerPlan", "MAX_GRID_FRAMES", "PassPlan",
           "SMEM_LIMIT", "ShaderPass", "WORKSPACE_LIMIT", "build_pass_plan",
           "count_passes", "out_size", "out_spatial_chain", "same_pads"]
