"""Wrappers of the port's four MiniConv CUDA kernels.

* :func:`miniconv_pass` (K2) — one shader pass, the counterpart of the
  reference's ``miniconv_pass`` / ``_pass_kernel``.
  ``kernels.ops.miniconv_layer`` launches it once per 4-channel output
  group, on the group's weight view: the ``reference`` backend, the
  oracle of the fused tier.
* :func:`miniconv_layer_grouped` (K3) — one layer, every output group in
  one launch, the counterpart of ``miniconv_layer_grouped`` /
  ``_layer_group_kernel``: the ``grouped`` backend.  K2 and K3 are one
  tiled layer kernel (``csrc/miniconv_layer.cu``), cut into blocks by
  ``core.passplan.plan_conv_tiles``.
* :func:`miniconv_encoder` (K1) — a whole PassPlan, optionally with the
  projection epilogue, in one launch of one block per halo tile
  (``csrc/miniconv_encoder.cu``), the counterpart of ``miniconv_encoder``
  / ``_encoder_kernel``: the ``fused`` and ``fused+head`` backends.
* :func:`miniconv_encoder_stream` (K4) — K1's layer body in persistent
  blocks that walk the batch's tiles, each layer pass over one or more
  frames of a tile, and fetch each next pass's input while they compute
  (same source), the counterpart of ``miniconv_encoder_stream`` /
  ``_miniconv_encoder_pipelined``: ``fused+stream``, and plain ``fused``
  past ``max_safe_batch``.

A wrapper given CPU tensors computes with the kernel's plain PyTorch
version (``kernels/ref.py``).  Given CUDA tensors it launches the kernel or
raises; nothing falls back.  Each wrapper counts its launches in a plain
integer attribute (``miniconv_pass.launches`` and so on) that a run may
reset and read to show which kernels a path went through; K2 and K3 also
count the inputs they had to copy (``miniconv_pass.copies``,
``miniconv_layer_grouped.copies``).
"""
from __future__ import annotations

import array

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.passplan import (ENCODER_THREADS, SMEM_LIMIT,
                                      plan_conv_tiles)
from repro_torch.kernels._build import aligned, launch, on_one_device
from repro_torch.kernels.ref import (miniconv_encoder_ref,
                                     miniconv_encoder_stream_ref,
                                     miniconv_layer_grouped_ref,
                                     miniconv_pass_ref)

_ACT_CODES = {"relu": 0, "sigmoid": 1, "linear": 2}


def _kernel_arg(t: torch.Tensor, what: str) -> torch.Tensor:
    """A contiguous, 16-byte-aligned fp32 tensor for a kernel pointer."""
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be float32 for the CUDA kernel, got "
                        f"{t.dtype}")
    return aligned(t)


# ---------------------------------------------------------------------------
# K2 and K3: one tiled layer kernel
# ---------------------------------------------------------------------------

def tap_stride(w: torch.Tensor) -> int:
    """Floats between neighbouring (i, j, c) taps of a (kh, kw, C_in,
    C_out) weight when the layer kernels can read it in place: unit-stride
    output channels and the taps one stride apart in (i, j, c) order, as
    in a contiguous weight (``C_out``) or its 4-channel group view
    ``w[..., g:g + 4]`` (the layer's C_out).  0 when they cannot."""
    (_, kw, c_in, c_out), (s0, s1, s2, s3) = w.shape, w.stride()
    if s3 == 1 and s2 >= c_out and s1 == c_in * s2 and s0 == kw * s1:
        return s2
    return 0


def layer_args(ptrs, dims, w_ld: int, tp, grouped: bool) -> array.array:
    """The int64 argument array of one K2 or K3 launch (``enum Arg`` in
    ``csrc/miniconv_layer.cu``, up to the device and stream that
    ``_build.launch`` appends): the pointers of x, w, b and y; ``dims`` =
    (B, H_in, W_in, C_in, kh, kw, stride, H_out, W_out, C_out); the
    weight's tap stride; the tile plan ``tp``
    (``core.passplan.plan_conv_tiles``); 1 for K3, 0 for K2."""
    return array.array("q", (*ptrs, *dims, w_ld, *tp.launch_ints, grouped))


def _layer_inputs(wrapper, x, w, b):
    """(x, w, b, w's tap stride) as the layer kernels read them: x and b
    contiguous, w in place where :func:`tap_stride` allows; whatever is
    not is copied, counted in ``wrapper.copies``."""
    f32 = torch.float32
    if x.dtype is not f32 or w.dtype is not f32 or b.dtype is not f32:
        raise TypeError(f"x, w and b must be float32 for the CUDA kernel, "
                        f"got {x.dtype}, {w.dtype}, {b.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
        wrapper.copies += 1
    if not b.is_contiguous():
        b = b.contiguous()
        wrapper.copies += 1
    ld = tap_stride(w)
    if not ld:
        w = w.contiguous()
        ld = w.shape[-1]
        wrapper.copies += 1
    return x, w, b, ld


def launch_layer(x, w, b, *, stride: int, tp, grouped: bool):
    """Launch K3 (``grouped``) or K2 on CUDA tensors with the tile plan
    ``tp``; returns (B, H_out, W_out, C_out).  The wrappers pass
    ``plan_conv_tiles``'s plan (None for an empty batch: nothing to
    launch); a caller may pass any plan of ``conv_candidates``, with which
    the kernel computes the same values.  Counts no launch."""
    wrapper = miniconv_layer_grouped if grouped else miniconv_pass
    B, h_in, w_in, c_in = x.shape
    kh, kw, _, c_out = w.shape
    h_out, w_out = (h_in - kh) // stride + 1, (w_in - kw) // stride + 1
    dev = x.device
    x, w, b, ld = _layer_inputs(wrapper, x, w, b)
    y = torch.empty((B, h_out, w_out, c_out), dtype=torch.float32,
                    device=dev)
    if tp is None:
        return y
    args = layer_args(
        (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr()),
        (B, h_in, w_in, c_in, kh, kw, stride, h_out, w_out, c_out), ld, tp,
        grouped)
    launch("miniconv_layer", wrapper.__name__, dev, args)
    return y


def _layer(wrapper, grouped: bool, x, w, b, stride: int):
    """K2 (4 channels) or K3 on CUDA tensors, their plain version on CPU
    tensors, after the checks.  Reads each tensor attribute once: at the
    served shape the call's host time is most of the layer's cost."""
    xs, ws, bs = x.shape, w.shape, b.shape
    B, h_in, w_in, c_in = xs
    kh, kw, c_in_w, c_out = ws
    if grouped:
        if c_in != c_in_w or c_out < 4 or c_out % 4 or tuple(bs) != (c_out,):
            raise ValueError(f"grouped layer takes x (B,H,W,C), w (kh,kw,C,"
                             f"C_out%4==0), b (C_out,); got {tuple(xs)}, "
                             f"{tuple(ws)}, {tuple(bs)}")
    elif c_in != c_in_w or c_out != 4 or tuple(bs) != (4,):
        raise ValueError(f"pass takes x (B,H,W,C), w (kh,kw,C,4), b (4,); "
                         f"got {tuple(xs)}, {tuple(ws)}, {tuple(bs)}")
    if h_in < kh or w_in < kw or stride < 1:
        raise ValueError(f"input {h_in}x{w_in} smaller than kernel "
                         f"{kh}x{kw} or stride {stride} < 1")
    if grouped and 4 * kh * kw * c_in * c_out > SMEM_LIMIT:
        raise ValueError(f"layer weights of {4 * kh * kw * c_in * c_out} B "
                         f"exceed the {SMEM_LIMIT} B of shared memory a "
                         f"block may use")
    dev = x.device
    if w.device != dev or b.device != dev:
        dev = on_one_device(x, w, b)        # raises, naming the devices
    if dev.type == "cpu":
        ref = miniconv_layer_grouped_ref if grouped else miniconv_pass_ref
        return ref(x, w, b, stride=stride)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tp = plan_conv_tiles(B, (h_in - kh) // stride + 1,
                         (w_in - kw) // stride + 1, kh, kw, stride, c_in,
                         c_out, grouped) if B else None
    y = launch_layer(x, w, b, stride=stride, tp=tp, grouped=grouped)
    wrapper.launches += tp is not None
    return y


def miniconv_pass(x, w, b, *, stride: int = 1):
    """One shader pass on a pre-padded input (VALID convolution).

    x: (B, H_in, W_in, C_in); w: (kh, kw, C_in, 4); b: (4,).
    Returns (B, H_out, W_out, 4) with
    H_out = (H_in - kh)//stride + 1, W_out = (W_in - kw)//stride + 1.

    On CUDA (K2) ``w`` may be the 4-channel group view ``kernel[...,
    g:g + 4]`` of a layer's weight: the kernel reads it in place.  Inputs
    it cannot read in place are copied, counted in
    ``miniconv_pass.copies``.
    """
    return _layer(miniconv_pass, False, x, w, b, stride)


miniconv_pass.launches = 0
miniconv_pass.copies = 0


def miniconv_layer_grouped(x, w, b, *, stride: int = 1):
    """All output groups of one layer in a single launch (VALID conv).

    x: (B, H_in, W_in, C_in) pre-padded; w: (kh, kw, C_in, C_out) with
    C_out % 4 == 0 (callers pad; see ``kernels.ops.miniconv_layer``);
    b: (C_out,).  Returns (B, H_out, W_out, C_out).  On CUDA (K3) it sums
    each output as K2 does, so it equals K2's groups bit for bit; inputs
    it cannot read in place are copied, counted in
    ``miniconv_layer_grouped.copies``.
    """
    return _layer(miniconv_layer_grouped, True, x, w, b, stride)


miniconv_layer_grouped.launches = 0
miniconv_layer_grouped.copies = 0


# ---------------------------------------------------------------------------
# K1: the whole encoder, optional projection epilogue
# ---------------------------------------------------------------------------

_MAX_LAYERS = 8     # the weight and bias slots of the launch array


def encoder_desc(plan, tp) -> list[int]:
    """The ints ``miniconv_encoder.cu`` reads: the tile header (ending in
    the frames of a layer pass), then per layer its
    geometry (kernel, stride, c_in, c_out, in_h, in_w, out_h, out_w,
    pad_top, pad_left, activation code) and its share of the tile
    (region, row, reader's stride, origin, register tile, shared-memory
    offsets)."""
    out = [tp.tile_h, tp.tile_w, tp.tiles_y, tp.tiles_x, tp.group,
           tp.in_ext_h, tp.in_ext_w, tp.in_row, *tp.in_org_h, *tp.in_org_w,
           tp.in_off, tp.smem_floats, tp.frames]
    for l, lt in zip(plan.layers, tp.layers):
        out += [l.kernel, l.stride, l.c_in, l.c_out, l.in_h, l.in_w,
                l.out_h, l.out_w, l.pad_top, l.pad_left,
                _ACT_CODES[l.activation], lt.ext_h, lt.ext_w, lt.row,
                lt.next_stride, *lt.org_h, *lt.org_w, lt.pix, lt.co_block,
                lt.co_pad, lt.w_off, lt.b_off, lt.out_off]
    return out


def head_parts(head_dim: int) -> int:
    """Runs a tile's features split into for the projection epilogue, so
    that (run, column lane) pairs fill a block: a lane takes 4 columns
    when ``head_dim`` allows 16-byte loads, else 1."""
    lanes = head_dim // 4 if head_dim % 4 == 0 else head_dim
    return max(1, ENCODER_THREADS // lanes)


_DESC_CACHE: dict = {}


def _desc_array(plan, batch: int, streamed: bool):
    """(tile plan, int32 array of :func:`encoder_desc`) for a launch, kept
    per plan object so that a served call does not rebuild them."""
    key = (id(plan), batch, streamed)
    hit = _DESC_CACHE.get(key)
    if hit is None or hit[0] is not plan:
        tp = plan.tile_plan(batch, streamed=streamed)
        if len(_DESC_CACHE) > 256:
            _DESC_CACHE.clear()
        hit = _DESC_CACHE[key] = (plan, tp,
                                  array.array("i", encoder_desc(plan, tp)))
    return hit[1], hit[2]


def prepare_fused_head(head_w, plan):
    """Lay a (plan.flat_features, D) head weight out for the epilogue.

    The CUDA epilogue reads the weight as it is — rows in the features'
    NHWC (h, w, c) order, row-major — so this checks the shape and makes
    it contiguous; the reference's row tiling and 128-lane padding exist
    for the TPU and have no counterpart here.
    """
    if head_w.ndim != 2 or head_w.shape[0] != plan.flat_features:
        raise ValueError(f"head weight must be ({plan.flat_features}, D), "
                         f"got {tuple(head_w.shape)}")
    return head_w.contiguous()


def _check_encoder_args(x, weights, biases, plan, head_w, head_b,
                        head_act):
    """Raise on inputs K1 and K4 do not take; returns the laid-out head
    weight and the device every tensor lies on."""
    L = len(plan.layers)
    h, w_sz, c_in = x.shape[1:]
    if (h, w_sz) != (plan.in_h, plan.in_w) or c_in != plan.layers[0].c_in:
        raise ValueError(f"input {tuple(x.shape)} does not match the plan's "
                         f"{plan.in_h}x{plan.in_w}x{plan.layers[0].c_in}")
    if not (len(weights) == L == len(biases)) or L > _MAX_LAYERS:
        raise ValueError(f"need one weight and bias per layer (<= "
                         f"{_MAX_LAYERS} layers), got {len(weights)}/"
                         f"{len(biases)} for {L}")
    for l, wt, bi in zip(plan.layers, weights, biases):
        if (tuple(wt.shape) != (l.kernel, l.kernel, l.c_in, l.c_out)
                or tuple(bi.shape) != (l.c_out,)):
            raise ValueError(f"layer {l.index}: weight {tuple(wt.shape)} / "
                             f"bias {tuple(bi.shape)} do not match the plan")
    if head_w is not None:
        head_w = prepare_fused_head(head_w, plan)
        if head_b is not None and tuple(head_b.shape) != (head_w.shape[1],):
            raise ValueError(f"head bias {tuple(head_b.shape)} != "
                             f"({head_w.shape[1]},)")
        if head_act not in _ACT_CODES:
            raise ValueError(f"unknown head_act {head_act!r}")
    return head_w, on_one_device(x, *weights, *biases, head_w, head_b)


def _launch_encoder(x, weights, biases, plan, head_w, head_b, head_act,
                    dev, chunk_b=None, tp=None):
    """Launch K1 (``chunk_b`` None: one block per tile item) or K4 (at
    most ``chunk_b`` frames' items in flight, in persistent blocks) on
    CUDA tensors, with the plan's tiles or the tile plan ``tp``; returns
    what :func:`miniconv_encoder` returns."""
    with tracing.span("encoder.prepare"):
        B = x.shape[0]
        L = len(plan.layers)
        streamed = chunk_b is not None
        if tp is None:
            tp, desc = _desc_array(plan, B, streamed)
        else:
            desc = array.array("i", encoder_desc(plan, tp))
        x = _kernel_arg(x, "x")
        # a layer whose weights are not staged is read from device memory
        # in the staged layout: (kh, kw, c_in, co_pad), zero past c_out
        ws = [_kernel_arg(t if lt.w_off >= 0 or lt.co_pad == t.shape[-1]
                          else F.pad(t, (0, lt.co_pad - t.shape[-1])),
                          "weight")
              for t, lt in zip(weights, tp.layers)]
        bs = [_kernel_arg(t, "bias") for t in biases]
        feats = torch.empty((B,) + plan.feature_shape, dtype=torch.float32,
                            device=dev)
        z = hw = hb = partial = done = None
        d_out = 0
        if head_w is not None:
            hw = _kernel_arg(head_w, "head_w")
            hb = None if head_b is None else _kernel_arg(head_b, "head_b")
            d_out = hw.shape[1]
            z = torch.empty((B, d_out), dtype=torch.float32, device=dev)
            partial = torch.empty(
                (B * tp.n_tiles * head_parts(d_out) * d_out,),
                dtype=torch.float32, device=dev)
        if head_w is not None or streamed:
            # per-frame tile counts, then K4's item counter
            done = torch.zeros((B + streamed,), dtype=torch.int32,
                               device=dev)

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        unused = (0,) * (_MAX_LAYERS - L)
        # enum Arg in csrc/miniconv_encoder.cu; blocks 0 launches K1
        args = array.array("q", (
            x.data_ptr(), feats.data_ptr(), ptr(z), ptr(partial), ptr(done),
            desc.buffer_info()[0], L, *[t.data_ptr() for t in ws], *unused,
            *[t.data_ptr() for t in bs], *unused, ptr(hw), ptr(hb), d_out,
            _ACT_CODES[head_act], head_parts(max(d_out, 1)), B,
            tp.stream_blocks(B, chunk_b) if streamed else 0, tp.smem_bytes))
    with tracing.span("encoder.launch"):
        launch("miniconv_encoder", "miniconv_encoder_stream" if streamed
               else "miniconv_encoder", dev, args)
    if streamed:
        miniconv_encoder_stream.launches += 1
    else:
        miniconv_encoder.launches += 1
    return feats if z is None else (feats, z)


def miniconv_encoder(x, weights, biases, plan, *, tile_h: int = 8,
                     head_w=None, head_b=None, head_act: str = "relu"):
    """Execute a whole :class:`~repro_torch.core.passplan.PassPlan` as ONE
    kernel launch (one thread block per halo tile of
    ``plan.tile_plan(B)``).

    x: (B, H, W, C_in) with (H, W) == (plan.in_h, plan.in_w);
    weights/biases: per-layer lists, HWIO kernels and (C_out,) biases.
    Returns (B, plan.out_h, plan.out_w, plan.k_out) float32 — SAME padding,
    fp32 accumulation, per-layer activation.

    ``head_w`` ((plan.flat_features, D), optional) adds the projection
    epilogue: the return value becomes ``(features, head_act(
    features.reshape(B, -1) @ head_w + head_b))``, computed in the same
    launch.  ``tile_h`` is accepted for the reference's signature and does
    not change the result.
    """
    with tracing.span("encoder.check"):
        head_w, dev = _check_encoder_args(x, weights, biases, plan, head_w,
                                          head_b, head_act)
    if dev.type == "cpu":
        return miniconv_encoder_ref(x, weights, biases, plan, head_w=head_w,
                                    head_b=head_b, head_act=head_act)
    return _launch_encoder(x, weights, biases, plan, head_w, head_b,
                           head_act, dev)


miniconv_encoder.launches = 0


# ---------------------------------------------------------------------------
# K4: the encoder streamed through persistent blocks
# ---------------------------------------------------------------------------

def miniconv_encoder_stream(x, weights, biases, plan, *, chunk_b: int,
                            tile_h: int = 8, head_w=None, head_b=None,
                            head_act: str = "relu"):
    """The fused encoder over a batch larger than one chunk, in ONE launch
    of persistent blocks (K4).

    The batch's tile items (``plan.tile_plan(B, streamed=True)``, each a
    tile of ``group`` frames) are walked frame group by frame group by at
    most ``ceil(chunk_b / group) * tiles`` resident blocks, so about
    ``chunk_b`` frames are in flight (``chunk_b`` should come from
    ``PassPlan.max_safe_batch``, the frames that fill one wave of resident
    blocks).  A block runs each layer over ``frames`` of an item's frames
    at once and fetches its next pass's input while it computes this one.
    Each pass runs K1's layer code at K1's tile size, so the result
    equals :func:`miniconv_encoder` bit for bit at every batch.  A batch
    within one chunk falls through to K1.  Arguments and return value are
    :func:`miniconv_encoder`'s.
    """
    if chunk_b < 1:
        raise ValueError(f"chunk_b must be >= 1, got {chunk_b}")
    if x.shape[0] <= chunk_b:             # fits one chunk: nothing to stream
        return miniconv_encoder(x, weights, biases, plan, tile_h=tile_h,
                                head_w=head_w, head_b=head_b,
                                head_act=head_act)
    with tracing.span("encoder.check"):
        head_w, dev = _check_encoder_args(x, weights, biases, plan, head_w,
                                          head_b, head_act)
    if dev.type == "cpu":
        return miniconv_encoder_stream_ref(x, weights, biases, plan,
                                           head_w=head_w, head_b=head_b,
                                           head_act=head_act)
    return _launch_encoder(x, weights, biases, plan, head_w, head_b,
                           head_act, dev, chunk_b=chunk_b)


miniconv_encoder_stream.launches = 0


def launch_encoder(x, weights, biases, plan, tp, *, chunk_b=None,
                   head_w=None, head_b=None, head_act: str = "relu"):
    """K1 (``chunk_b`` None) or K4 on CUDA tensors with the tile plan
    ``tp``: a layout of ``passplan.tile_layout`` (K4: any of
    ``tile_candidates``), with which the kernels compute the same
    features as with the plan's own.  Checks the arguments as the
    wrappers do and counts the launch in theirs.  Returns what
    :func:`miniconv_encoder` returns."""
    head_w, dev = _check_encoder_args(x, weights, biases, plan, head_w,
                                      head_b, head_act)
    if dev.type != "cuda" or (tp.group > 1) != (chunk_b is not None):
        raise ValueError(f"launch_encoder takes CUDA tensors and a "
                         f"{'K4' if chunk_b else 'K1'} layout")
    return _launch_encoder(x, weights, biases, plan, head_w, head_b,
                           head_act, dev, chunk_b=chunk_b, tp=tp)


__all__ = ["encoder_desc", "head_parts", "launch_encoder", "launch_layer",
           "layer_args", "miniconv_encoder", "miniconv_encoder_stream",
           "miniconv_layer_grouped", "miniconv_pass", "prepare_fused_head",
           "tap_stride"]
