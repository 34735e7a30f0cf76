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
kernel's 16 MiB VMEM; the port models its own CUDA kernels
(``kernels/csrc/miniconv_encoder.cu``), which cut a launch into halo
tiles: one block computes one tile of the last layer's output and every
earlier layer's region under it, all in its shared memory.
:meth:`PassPlan.tile_plan` (:class:`TilePlan`) picks the tile size and
the frames of a layer pass by a cost model (:func:`tile_cost`), and lays
out each region, its origin and its buffer; the kernels read that plan as
it is, so the CPU tests reach all of the tile arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools
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


# Launch model of the fused CUDA kernels (K1, K4) on an H100 SXM.
# Dynamic shared memory one thread block may use (after raising
# cudaFuncAttributeMaxDynamicSharedMemorySize).
SMEM_LIMIT = 232_448
# Shared memory of one SM, which its resident blocks share, and what the
# runtime reserves of it for each block.
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
# Streaming multiprocessors of the card.
N_SMS = 132
# Threads of one encoder block, and the blocks an SM keeps resident at
# most: ``__launch_bounds__(256, 2)`` in ``miniconv_encoder.cu`` caps the
# kernel at 128 registers a thread so that two blocks fit.
ENCODER_THREADS = 256
MAX_BLOCKS_PER_SM = 2
# Static shared memory of the encoder kernels: an int a frame of an item,
# and the projection's run sums (4 floats a thread).
SMEM_STATIC = 16 + 4 * 4 * ENCODER_THREADS
# (pixels a thread owns, output channels it accumulates): the shapes of a
# thread's register tile that the kernel is compiled for.
TASK_SHAPES = ((2, 8), (1, 16), (1, 8), (2, 4), (1, 4))
# Frames one K4 item carries through the projection: the item's tile of
# each frame is computed a pass of ``TilePlan.frames`` frames at a time,
# then their partial projections read each row of W once for all of them.
FRAMES_PER_ITEM = 4


@dataclasses.dataclass(frozen=True)
class EncoderCost:
    """The constants of the fused kernels' tile model: the SM cycles one
    (tap, input channel) step of a thread takes beyond issuing its own
    instructions (its shared-memory loads' latency, which only other
    warps can hide), and the cycles of one thread to stage one input
    value (index arithmetic, a 4-byte cp.async and its wait)."""

    step_latency: float
    load_cost: float


# A best grid point of ``python -m repro_torch.benchmarks.encoder_tiles
# --fit`` over its sweep of every K4 layout at the benchmark's two shapes,
# timed on the card (NVIDIA H100 80GB HBM3, 700 W): its picks are the
# fastest layouts at both, and the rank correlation of its modelled costs
# with the times is 0.975 (25 and 64 read the same).
ENCODER_COST = EncoderCost(step_latency=20, load_cost=32)


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

    # ---- launch plan of the fused CUDA kernels -----------------------------
    def tile_plan(self, batch: Optional[int] = 1, *,
                  streamed: bool = False) -> "TilePlan":
        """How K1 (``streamed=False``) or K4 (``streamed=True``) cuts a
        ``batch``-frame launch into halo tiles (:func:`plan_tiles`).
        ``batch=None`` plans for a batch large enough that only the card's
        throughput counts."""
        return plan_tiles(self, batch, streamed=streamed)

    def max_safe_batch(self) -> int:
        """Frames whose tile items fill one wave of the streamed kernel's
        resident blocks (each item carries ``group`` frames), under K4's
        throughput plan (tile size and frames a pass, which set the blocks
        an SM holds): the batch the card holds at once.
        Larger batches stream through K4, which fetches each block's next
        pass while it computes the current one."""
        tp = self.tile_plan(None, streamed=True)
        return tp.group * -(-tp.resident_blocks // tp.n_tiles)

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


# ---------------------------------------------------------------------------
# Halo tiles of the fused CUDA kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerTile:
    """One layer's share of a halo tile: the region of the layer's output
    that one tile item computes, where it starts, each thread's register
    tile, and the layer's buffers in the block's shared memory (offsets in
    floats)."""

    ext_h: int                  # rows of the output region
    ext_w: int                  # columns of the output region
    row: int                    # floats of one region row in shared memory
    next_stride: int            # stride of the layer that reads it; 0: last
    org_h: tuple[int, int]      # first row: ty * org_h[0] - org_h[1]
    org_w: tuple[int, int]      # first column: tx * org_w[0] - org_w[1]
    pix: int                    # output pixels a thread owns
    co_block: int               # output channels a thread accumulates
    co_pad: int                 # c_out rounded up to co_block
    w_off: int                  # weights (kh, kw, c_in, co_pad); -1: unstaged
    b_off: int                  # bias, (co_pad,)
    out_off: int                # output region (see TilePlan)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How a fused launch cuts its frames into halo tiles.

    A tile item is one ``tile_h`` x ``tile_w`` block of the last layer's
    output of ``group`` frames (1 in K1).  Its block stages the input
    region the item needs (``in_ext_h`` x ``in_ext_w``, zero outside the
    frame) and computes each earlier layer over the region the next one
    reads; positions of a region outside that layer's output are staged
    as zero, the next layer's SAME padding.  A region is CHW, each row's
    columns split by phase modulo the reading layer's stride (column x at
    ``(x % s) * (row / s) + x // s``), so neighbouring threads of a
    stride-s layer read neighbouring floats.  The last layer's region is
    the tile itself, HWC, one slot per frame of the item.

    One layer pass covers ``frames`` frames of an item (1 in K1): each
    region, and the input buffer, holds that many frames one after the
    other, and a layer's register tile is chosen for the pass's pixels.
    K4 fetches its next pass's input into the same buffer as soon as the
    first layer, its only reader, has read it, so that it lands while the
    later layers run.  ``work`` and ``chain`` model one pass.
    """

    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    group: int
    in_ext_h: int
    in_ext_w: int
    in_row: int
    in_org_h: tuple[int, int]
    in_org_w: tuple[int, int]
    in_off: int                 # the input buffer, ``frames`` frames
    layers: tuple[LayerTile, ...]
    smem_floats: int
    frames: int                 # frames of one layer pass
    work: float                 # SM issue cycles of one pass (model)
    chain: float                # cycles of its busiest thread (model)

    @property
    def n_tiles(self) -> int:
        """Tiles of one frame."""
        return self.tiles_y * self.tiles_x

    def n_items(self, batch: int) -> int:
        """Items of a ``batch``-frame launch."""
        return -(-batch // self.group) * self.n_tiles

    def n_passes(self, batch: int) -> int:
        """Layer passes of a ``batch``-frame launch: each item's frames
        ``frames`` at a time, the last item's ragged."""
        full, left = divmod(batch, self.group)
        per = _cdiv(self.group, self.frames)
        return (full * per + _cdiv(left, self.frames)) * self.n_tiles

    def stream_blocks(self, batch: int, chunk_b: int) -> int:
        """Persistent blocks of a K4 launch over ``batch`` frames with
        about ``chunk_b`` frames in flight: ``ceil(chunk_b / group)``
        frame groups' tiles, at most one block per item and the blocks
        the card keeps resident."""
        return min(self.n_items(batch), self.resident_blocks,
                   -(-chunk_b // self.group) * self.n_tiles)

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_floats

    @property
    def blocks_per_sm(self) -> int:
        return min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (
            self.smem_bytes + SMEM_STATIC + SMEM_RESERVED))

    @property
    def resident_blocks(self) -> int:
        return N_SMS * self.blocks_per_sm

    def recompute(self, plan: "PassPlan") -> float:
        """Outputs the tiles compute over those the frame needs, summed
        over the layers (edge positions outside a layer count too)."""
        done = sum(lt.ext_h * lt.ext_w * l.c_out
                   for lt, l in zip(self.layers, plan.layers))
        need = sum(l.out_h * l.out_w * l.c_out for l in plan.layers)
        return self.n_tiles * done / need


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def layer_cycles(n_pix: int, l: "LayerPlan", shape: tuple[int, int],
                 model: EncoderCost = ENCODER_COST) -> tuple[float, float]:
    """(SM issue cycles, cycles of the busiest thread) of one layer pass
    over ``n_pix`` outputs (a pass's frames together), a thread owning
    ``shape`` = (pixels, channels).  Per (tap, input channel) a task
    issues P x CB FMAs, P input loads (neighbouring lanes on neighbouring
    floats, one wavefront) and CB / 4 16-byte weight loads (one address
    across the warp); an SM issues 4 warp FMAs a cycle and serves one
    shared-memory wavefront a cycle.  A thread's chain is its tasks'
    steps, each its instructions plus the loads' latency: however few
    warps a pass fills, it lasts that long."""
    p, cb = shape
    taps = l.kernel * l.kernel * l.c_in
    tasks = _cdiv(n_pix, p) * _cdiv(l.c_out, cb)
    sm = _cdiv(tasks, 32) * taps * max(p * cb / 4, p + cb / 4)
    chain = (_cdiv(tasks, ENCODER_THREADS) * taps
             * (p * cb + p + cb / 4 + model.step_latency))
    return sm, chain


def task_shape(n_pix: int, l: "LayerPlan") -> tuple[int, int]:
    """(pixels, channels) of each thread's register tile for a layer pass
    over ``n_pix`` outputs: the shape whose pass takes the fewest cycles
    by :func:`layer_cycles` on an SM of its own, then the one that uses
    the SM least."""
    def key(shape):
        sm, chain = layer_cycles(n_pix, l, shape)
        return (max(sm, chain), sm)
    return min(TASK_SHAPES, key=key)


def _split_row(width: int, stride: int) -> int:
    """Floats of a region row of ``width`` columns split by phase modulo
    ``stride``: ``stride`` phases of ``ceil(width / stride)`` each."""
    return stride * _cdiv(width, stride)


def pass_cycles(plan: "PassPlan", tp: TilePlan,
                model: EncoderCost = ENCODER_COST) -> tuple[float, float]:
    """(SM issue cycles, cycles of the busiest thread) of one pass of
    ``tp``'s layout: its layers by :func:`layer_cycles` at their register
    tiles, and the staging of its frames' input regions."""
    work = chain = 0.0
    for l, lt in zip(plan.layers, tp.layers):
        sm, ch = layer_cycles(tp.frames * lt.ext_h * lt.ext_w, l,
                              (lt.pix, lt.co_block), model)
        work, chain = work + sm, chain + ch
    staged = tp.frames * tp.in_ext_h * tp.in_ext_w * plan.layers[0].c_in
    work += _cdiv(staged, 32) * model.load_cost / 4
    chain += _cdiv(staged, ENCODER_THREADS) * model.load_cost
    return work, chain


def tile_layout(plan: "PassPlan", th: int, tw: int, streamed: bool = False,
                staged_weights: bool = True, *, frames: int = 1) -> TilePlan:
    """The tile plan for ``th`` x ``tw`` output tiles: each layer's
    region, walked back from the tile through every layer's stride,
    kernel and SAME padding, and one block's shared memory, laid out as
    weights (unless ``staged_weights`` is False: the kernel then reads
    them, padded to ``co_pad`` columns, from device memory; ``w_off`` is
    -1) and biases, then the input buffer of ``frames`` frames, then the
    regions of ``frames`` frames, each 16-byte aligned.  A streamed item
    carries ``FRAMES_PER_ITEM`` frames, and a pass ``frames`` of them; K1
    (``streamed`` False) takes one frame and one pass."""
    group = FRAMES_PER_ITEM if streamed else 1
    if not 1 <= frames <= group:
        raise ValueError(f"no {'K4' if streamed else 'K1'} layout with "
                         f"{frames} frames a pass")
    regions = []                # per layer, last first: (eh, ew, org_h, org_w)
    eh, ew, mh, ah, mw, aw = th, tw, th, 0, tw, 0
    for l in reversed(plan.layers):
        regions.append((eh, ew, (mh, ah), (mw, aw)))
        eh, ew = (eh - 1) * l.stride + l.kernel, (ew - 1) * l.stride + l.kernel
        mh, ah = mh * l.stride, ah * l.stride + l.pad_top
        mw, aw = mw * l.stride, aw * l.stride + l.pad_left
    regions.reverse()
    off = 0

    def alloc(n):
        nonlocal off
        start, off = off, off + _round4(n)
        return start

    shapes, wb = [], []
    for l, (reh, rew, _, _) in zip(plan.layers, regions):
        p, cb = task_shape(frames * reh * rew, l)
        co_pad = _cdiv(l.c_out, cb) * cb
        shapes.append((p, cb, co_pad))
        n_w = l.kernel * l.kernel * l.c_in * co_pad
        wb.append((alloc(n_w) if staged_weights else -1, alloc(co_pad)))
    first = plan.layers[0]
    in_row = _split_row(ew, first.stride)
    in_elems = eh * in_row * first.c_in
    in_off = alloc(frames * in_elems)
    layers = []
    n = len(plan.layers)
    for i, (l, (reh, rew, oh, ow), (p, cb, co_pad), (w_off, b_off)) in \
            enumerate(zip(plan.layers, regions, shapes, wb)):
        if i == n - 1:
            nxt, row = 0, rew
            out_off = alloc(group * reh * rew * l.c_out)
        else:
            nxt = plan.layers[i + 1].stride
            row = _split_row(rew, nxt)
            out_off = alloc(frames * reh * row * l.c_out)
        layers.append(LayerTile(ext_h=reh, ext_w=rew, row=row,
                                next_stride=nxt, org_h=oh, org_w=ow, pix=p,
                                co_block=cb, co_pad=co_pad, w_off=w_off,
                                b_off=b_off, out_off=out_off))
    tp = TilePlan(tile_h=th, tile_w=tw, tiles_y=_cdiv(plan.out_h, th),
                  tiles_x=_cdiv(plan.out_w, tw), group=group, in_ext_h=eh,
                  in_ext_w=ew, in_row=in_row, in_org_h=(mh, ah),
                  in_org_w=(mw, aw), in_off=in_off, layers=tuple(layers),
                  smem_floats=off, frames=frames, work=0.0, chain=0.0)
    work, chain = pass_cycles(plan, tp)
    return dataclasses.replace(tp, work=work, chain=chain)


def tile_cost(tp: TilePlan, batch: Optional[int]) -> float:
    """Modelled SM cycles of a launch of ``tp`` over ``batch`` frames
    (K4's layouts; a K1 layout, one frame an item, prices K1): the
    larger of every pass's issue cycles spread over the card's SMs, and
    the rounds of items over the resident blocks times an item's passes,
    each the chain of its busiest thread, which lasts as long however few
    warps carry it.  The blocks an SM holds overlap their chains, so at
    large batches a pass costs an SM the larger of its issue cycles and
    its chain over those blocks.  ``batch=None`` counts throughput alone,
    per frame."""
    per_item = _cdiv(tp.group, tp.frames)
    if batch is None:
        per_pass = max(tp.work, tp.chain / tp.blocks_per_sm)
        return tp.n_tiles * per_item / tp.group * per_pass / N_SMS
    return max(tp.n_passes(batch) * tp.work / N_SMS,
               _cdiv(tp.n_items(batch), tp.resident_blocks) * per_item
               * tp.chain)


def tile_candidates(plan: "PassPlan", staged_weights: bool = True
                    ) -> list[TilePlan]:
    """Every K4 layout :func:`plan_tiles` chooses from: square tiles (cut
    to the output's sides) and passes of a whole share of an item's
    frames (1, 2 or 4 of ``FRAMES_PER_ITEM``), whose shared memory fits a
    block."""
    out = []
    for t in range(1, max(plan.out_h, plan.out_w) + 1):
        th, tw = min(t, plan.out_h), min(t, plan.out_w)
        fits = False
        for frames in (f for f in range(1, FRAMES_PER_ITEM + 1)
                       if FRAMES_PER_ITEM % f == 0):
            tp = tile_layout(plan, th, tw, True, staged_weights,
                             frames=frames)
            if tp.smem_bytes + SMEM_STATIC <= SMEM_LIMIT:
                out.append(tp)
                fits = True
        if not fits:
            break               # larger tiles only need more
    return out


@functools.lru_cache(maxsize=512)
def plan_tiles(plan: "PassPlan", batch: Optional[int] = 1, *,
               streamed: bool = False) -> TilePlan:
    """The tile plan of a fused launch over ``batch`` frames.

    The candidates are K4's layouts (:func:`tile_candidates`: tile size
    and frames a pass), priced by :func:`tile_cost`, which charges each
    pass the chain of its busiest thread, paid however few warps the pass
    fills: passes of more frames, or larger tiles, fill more warps for
    about the same chain, as long as the blocks' shared memory still lets
    two share an SM.  Past one wave of K4's resident blocks (``batch``
    None, or more than ``max_safe_batch`` frames: what runs is K4) the
    cheapest layout wins; up to it (what runs is K1, one block per tile of
    one frame) the tile size is the one whose K1 layout is cheapest, and
    K4 takes its cheapest layout at that tile size.  Ties go to the larger
    tile, then the fewer frames a pass.  So K1 and K4 take the same tile
    size at the same batch, and sum each frame's projection in the same
    order.  The layers' weights are staged in shared memory unless no tile
    fits with them.  Raises ``ValueError`` when not even a 1x1 tile fits.
    """
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    for staged in (True, False):
        cands = tile_candidates(plan, staged)
        if not cands:
            continue

        def cheapest(layouts, b):
            return min(layouts, key=lambda c: (tile_cost(c, b), -c.tile_h,
                                               c.frames))
        if batch is None or batch > plan.max_safe_batch():
            tp = cheapest(cands, batch)
        else:
            sides = dict.fromkeys((c.tile_h, c.tile_w) for c in cands)
            k1 = cheapest([tile_layout(plan, th, tw, False, staged)
                           for th, tw in sides], batch)
            tp = cheapest([c for c in cands if c.tile_h == k1.tile_h],
                          batch)
        return (tp if streamed else
                tile_layout(plan, tp.tile_h, tp.tile_w, False, staged))
    raise ValueError(f"no halo tile of {plan.in_h}x{plan.in_w} input fits "
                     f"the {SMEM_LIMIT} B of shared memory a block may use")


# ---------------------------------------------------------------------------
# Tiles of the layer kernels (K2, K3)
# ---------------------------------------------------------------------------

# Threads of one layer block at most (``__launch_bounds__(256, 2)`` in
# ``miniconv_layer.cu``), and the registers the model gives a thread of a
# P x CB register tile: ptxas gave the standard layers' instantiations
# 66-109 (chip_smoke, NVIDIA H100 80GB HBM3).
CONV_MAX_THREADS = 256


def _conv_regs(shape: tuple[int, int]) -> int:
    """Registers a thread of the layer kernels, modelled: 64 plus two per
    accumulator."""
    return 64 + 2 * shape[0] * shape[1]

# Register tiles of the pass kernel, which writes 4 channels.
PASS_TASK_SHAPES = tuple(s for s in TASK_SHAPES if s[1] == 4)
# Output tile sides the planner tries (a tile is at most 4 times as wide
# as it is high, or the other way round).
CONV_TILE_SIDES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
# Blocks an SM keeps resident at most, and its threads.
_BLOCKS_PER_SM = 32
_THREADS_PER_SM = 2048


@dataclasses.dataclass(frozen=True)
class ConvCost:
    """The constants of the layer kernels' cost model: cycles between one
    warp's instructions while its scheduler has too few warps to hide
    their latencies; instructions of one thread to stage one 16-byte
    copy; cycles of one block's start and end (launch, index arithmetic,
    barrier), paid in turn by the blocks of one SM; bytes L2 delivers a
    cycle to one SM, and to all SMs together."""

    warp_alone_cpi: float
    load_cost: float
    block_cycles: float
    sm_bytes_per_cycle: float
    l2_bytes_per_cycle: float


# The best grid point of ``python -m repro_torch.benchmarks.conv_tiles
# --fit`` over its sweep of every plan of the standard layers timed on the
# card (NVIDIA H100 80GB HBM3, 700 W): its picks come closest to the
# fastest plans.  The sweeps fix warp_alone_cpi and block_cycles; the
# other three sit on a plateau of equal picks.
CONV_COST = ConvCost(warp_alone_cpi=2, load_cost=4, block_cycles=250,
                     sm_bytes_per_cycle=64, l2_bytes_per_cycle=3000)


def conv_cost(work: tuple[int, ...], model: ConvCost = CONV_COST) -> float:
    """Modelled SM cycles of a launch of :attr:`ConvTilePlan.work`.

    The launch runs in waves of ``on_sm`` blocks on each SM.  A wave takes
    the longest of: its warps' instructions issued by the SM's 4
    schedulers (one warp's chain of staging copies and tap loop at
    ``warp_alone_cpi`` cycles an instruction while a scheduler holds fewer
    warps than that), its shared-memory wavefronts (one a cycle), and the
    bytes its blocks stage at one SM's share of L2; plus the first block's
    staging, before which nothing computes, and each block's start and
    end.  The whole launch's staged bytes at the L2's rate bound it too.
    """
    blocks, threads, resident, stage, steps, p, cb = work
    if resident < 1:
        return float("inf")
    on_sm = min(resident, _cdiv(blocks, N_SMS))
    warps = on_sm * threads // 32
    # per (tap, channel quad) a task issues 4 p cb FMAs, p region loads of
    # 16 B (4 wavefronts a warp) and cb weight quads (one address across
    # the warp: 1 wavefront each)
    instr = steps * (4 * p * cb + p + cb)
    chain = _cdiv(stage, threads) * model.load_cost + instr
    one = stage * 16 / model.sm_bytes_per_cycle
    # the blocks' staging overlaps the others' compute, but for the first
    # block's
    wave = (max(max(_cdiv(warps, 4), model.warp_alone_cpi) * chain,
                warps * steps * (4 * p + cb), on_sm * one)
            + one + on_sm * model.block_cycles)
    return max(_cdiv(blocks, N_SMS * on_sm) * wave,
               blocks * stage * 16 / model.l2_bytes_per_cycle)


@dataclasses.dataclass(frozen=True)
class ConvTilePlan:
    """How K2 or K3 cuts one layer's launch into blocks.

    A block owns a ``tile_h`` x ``tile_w`` tile of one frame's output and
    ``co_block`` of its output channels (block ``((n * tiles_y + ty) *
    tiles_x + tx) * co_blocks + cob``).  It stages the input region under
    the tile, ``in_ext_h`` x ``in_ext_w`` positions, as ``c4`` planes of
    float4 (input channels 4q .. 4q+3, zero past c_in), each row
    ``in_row`` float4 slots with its columns split by phase modulo the
    stride (column x at ``(x % s) * (in_row / s) + x // s``), and its
    channels' weights as ``(kh, kw, c_in, co_block)`` rows.  Shared memory
    holds the weights at 0, the bias at ``b_off`` and the region at
    ``in_off`` (floats).  A thread computes ``pix`` output pixels (tasks
    ``ceil(tile_h * tile_w / pix)`` apart) by ``cb`` channels.
    """

    batch: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    co_block: int
    co_blocks: int
    pix: int
    cb: int
    threads: int
    in_ext_h: int
    in_ext_w: int
    in_row: int
    c4: int
    b_off: int
    in_off: int
    smem_floats: int
    # what the cost model reads: blocks, threads a block, blocks an SM
    # holds, 16-byte copies a block stages, tap steps a thread, (P, CB)
    work: tuple[int, ...]

    @property
    def blocks(self) -> int:
        return self.batch * self.tiles_y * self.tiles_x * self.co_blocks

    @property
    def cost(self) -> float:
        """Modelled SM cycles of the launch (:func:`conv_cost`)."""
        return conv_cost(self.work)

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_floats

    @functools.cached_property
    def launch_ints(self) -> tuple[int, ...]:
        """The plan as the kernel's argument array carries it: tile_h,
        tile_w, co_block, pix, cb, threads, shared-memory bytes."""
        return (self.tile_h, self.tile_w, self.co_block, self.pix, self.cb,
                self.threads, self.smem_bytes)

    @property
    def tasks(self) -> int:
        """Register tiles of one block."""
        return (_cdiv(self.tile_h * self.tile_w, self.pix)
                * (self.co_block // self.cb))


def conv_tile_layout(batch: int, h_out: int, w_out: int, kh: int, kw: int,
                     stride: int, c_in: int, c_out: int, tile_h: int,
                     tile_w: int, co_block: int, shape: tuple[int, int]
                     ) -> ConvTilePlan:
    """The plan of ``tile_h`` x ``tile_w`` tiles of ``co_block`` channels
    and register tiles of ``shape`` = (pixels, channels), laid out."""
    p, cb = shape
    s = stride
    c4 = _cdiv(c_in, 4)
    ext_h = (tile_h - 1) * s + kh
    ext_w = (tile_w - 1) * s + kw
    row = _split_row(ext_w, s)
    w_floats = kh * kw * c_in * co_block
    b_off = w_floats
    in_off = b_off + co_block
    smem = in_off + 4 * c4 * ext_h * row
    tasks = _cdiv(tile_h * tile_w, p) * (co_block // cb)
    threads = min(CONV_MAX_THREADS, 32 * _cdiv(tasks, 32))
    tiles_y, tiles_x = _cdiv(h_out, tile_h), _cdiv(w_out, tile_w)
    blocks = batch * tiles_y * tiles_x * (c_out // co_block)
    # 16-byte copies a block stages: region, weights, bias
    stage = c4 * ext_h * ext_w + w_floats // 4 + co_block
    resident = min(_BLOCKS_PER_SM, _THREADS_PER_SM // threads,
                   65536 // (threads * _conv_regs(shape)),
                   SMEM_PER_SM // (4 * smem + SMEM_RESERVED))
    steps = _cdiv(tasks, threads) * kh * kw * c4
    return ConvTilePlan(batch=batch, tile_h=tile_h, tile_w=tile_w,
                        tiles_y=tiles_y, tiles_x=tiles_x, co_block=co_block,
                        co_blocks=c_out // co_block, pix=p, cb=cb,
                        threads=threads, in_ext_h=ext_h, in_ext_w=ext_w,
                        in_row=row, c4=c4, b_off=b_off, in_off=in_off,
                        smem_floats=smem,
                        work=(blocks, threads, resident, stage, steps, p, cb))


def conv_candidates(batch: int, h_out: int, w_out: int, kh: int, kw: int,
                    stride: int, c_in: int, c_out: int, grouped: bool = True
                    ) -> list[ConvTilePlan]:
    """Every plan :func:`plan_conv_tiles` chooses from: tile sides from
    ``CONV_TILE_SIDES`` (cut to the output's sides, at most 4:1), channel
    blocks that divide ``c_out`` in whole quads, and the register tiles of
    the kernel (K3: ``TASK_SHAPES``; K2, ``grouped=False``:
    ``PASS_TASK_SHAPES``) whose channels divide the block's; only plans
    whose shared memory fits a block."""
    if batch < 1 or h_out < 1 or w_out < 1 or c_out < 4 or c_out % 4:
        raise ValueError(f"no layer launch of batch {batch}, output "
                         f"{h_out}x{w_out}x{c_out} (c_out % 4 == 0)")
    if not grouped and c_out != 4:
        raise ValueError(f"a pass writes 4 channels, not {c_out}")
    shapes = TASK_SHAPES if grouped else PASS_TASK_SHAPES
    sides_h = sorted({min(t, h_out) for t in CONV_TILE_SIDES})
    sides_w = sorted({min(t, w_out) for t in CONV_TILE_SIDES})
    out = []
    for th in sides_h:
        for tw in sides_w:
            if max(th, tw) > 4 * min(th, tw) and th < h_out and tw < w_out:
                continue
            for co_block in range(4, c_out + 1, 4):
                if c_out % co_block:
                    continue
                for shape in shapes:
                    if co_block % shape[1]:
                        continue
                    tp = conv_tile_layout(batch, h_out, w_out, kh, kw,
                                          stride, c_in, c_out, th, tw,
                                          co_block, shape)
                    if tp.smem_bytes <= SMEM_LIMIT:
                        out.append(tp)
    return out


@functools.lru_cache(maxsize=1024)
def plan_conv_tiles(batch: int, h_out: int, w_out: int, kh: int, kw: int,
                    stride: int, c_in: int, c_out: int, grouped: bool = True
                    ) -> ConvTilePlan:
    """The plan of one K3 (``grouped``) or K2 launch: among the
    candidates of :func:`conv_candidates` that spread over every SM (or
    over as many blocks as the layer can be cut into, when that is
    fewer), the one with the least modelled cost; ties go to the fewer
    blocks, then the larger tile.  Raises ``ValueError`` when no plan
    fits a block's shared memory."""
    cands = conv_candidates(batch, h_out, w_out, kh, kw, stride, c_in,
                            c_out, grouped)
    if not cands:
        raise ValueError(f"no tile of a {kh}x{kw}x{c_in} layer fits the "
                         f"{SMEM_LIMIT} B of shared memory a block may use")
    return pick_conv_plan(cands)


def pick_conv_plan(cands: list[ConvTilePlan], model: ConvCost = CONV_COST
                   ) -> ConvTilePlan:
    """:func:`plan_conv_tiles`'s choice among ``cands`` under ``model``."""
    need = min(N_SMS, max(tp.blocks for tp in cands))
    return min((tp for tp in cands if tp.blocks >= need),
               key=lambda tp: (conv_cost(tp.work, model), tp.blocks,
                               -tp.tile_h * tp.tile_w))


__all__ = ["CONV_COST", "CONV_MAX_THREADS", "ConvCost", "ConvTilePlan",
           "ENCODER_COST", "ENCODER_THREADS", "EncoderCost",
           "FRAMES_PER_ITEM", "HeadPlan", "LayerPlan", "LayerTile",
           "MAX_BLOCKS_PER_SM", "N_SMS", "PASS_TASK_SHAPES", "PassPlan",
           "SMEM_LIMIT", "SMEM_PER_SM", "SMEM_STATIC", "ShaderPass",
           "TASK_SHAPES", "TilePlan", "build_pass_plan", "conv_candidates",
           "conv_cost", "conv_tile_layout", "count_passes", "layer_cycles",
           "out_size", "out_spatial_chain", "pass_cycles", "pick_conv_plan",
           "plan_conv_tiles", "plan_tiles", "same_pads", "task_shape",
           "tile_candidates", "tile_cost", "tile_layout"]
