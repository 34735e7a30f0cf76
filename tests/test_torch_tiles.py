"""The fused kernels' halo tiles (``PassPlan.tile_plan``), on the CPU.

K1 and K4 cut a launch into tiles of the last layer's output; each tile's
block stages the input region under it and computes every earlier layer
over the region the next one reads, storing a region's positions outside
its layer's output as zero (the next layer's SAME padding).  The kernels
read the tile plan as it is, so its arithmetic is checked here:

* the regions, origins and shared-memory layout of the tiles, at the
  paper's 84x84x12 and 400x400x4 frames, an odd 85x83 spec whose final
  size no tile divides, and a one-layer spec;
* an emulation of the kernels' tiling kept in this file: it cuts each
  halo region from the input, runs it through one VALID layer at a time
  with the edge positions zeroed, and stitches the tiles back.  Through a
  convolution that sums in the kernels' fixed order (bias, then i, j, c)
  it equals the whole frame through the same convolution bit for bit.
  Through the plain version (``miniconv_encoder_ref``, whose CPU
  ``F.conv2d`` sums in an order that depends on the input's size: up to
  2.1e-07 apart at these shapes) it is within 1e-6 of the whole-frame
  plain version and within 1e-5 of the reference's XLA path; the
  projection summed per run of a tile's features, then over the runs in
  order, as the kernels sum it, is within 1e-4 of the plain projection.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core import miniconv as j_miniconv
from repro_torch.convert import params_from_jax
from repro_torch.core import passplan as t_passplan
from repro_torch.core.miniconv import (_ACTS, LayerSpec, MiniConvSpec,
                                       standard_spec)
from repro_torch.kernels.miniconv_pass import encoder_desc, head_parts
from repro_torch.kernels.ref import miniconv_encoder_ref

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

FEAT_TOL = 1e-5
Z_TOL = 1e-4

ODD = MiniConvSpec((LayerSpec(4, 2, 12, 16, "relu"),
                    LayerSpec(3, 2, 16, 16, "sigmoid"),
                    LayerSpec(3, 2, 16, 6, "linear")))
ONE = MiniConvSpec((LayerSpec(3, 1, 8, 6, "sigmoid"),))


def _region(x, r0, c0, eh, ew):
    """Rows r0.. and columns c0.. of x (B, H, W, C), zero outside it."""
    B, H, W, C = x.shape
    out = x.new_zeros((B, eh, ew, C))
    y0, y1 = max(r0, 0), min(r0 + eh, H)
    x0, x1 = max(c0, 0), min(c0 + ew, W)
    if y1 > y0 and x1 > x0:
        out[:, y0 - r0:y1 - r0, x0 - c0:x1 - c0] = x[:, y0:y1, x0:x1]
    return out


def plain_layer(y, w, b, l):
    """One VALID layer ``l`` through the plain version."""
    valid = SimpleNamespace(layers=[SimpleNamespace(
        pad_top=0, pad_bottom=0, pad_left=0, pad_right=0, stride=l.stride,
        activation=l.activation)])
    return miniconv_encoder_ref(y, [w], [b], valid)


def ordered_layer(y, w, b, l):
    """One VALID layer ``l`` summing each output as the kernels do: bias,
    then (i, j, c) in order, each step rounded alone, so an output's value
    does not depend on the size of the tensor around it.  The activation
    runs in float64 and rounds once: the CPU's vectorised sigmoid and its
    scalar tail may differ in the last bit."""
    s, k = l.stride, l.kernel
    oh, ow = (y.shape[1] - k) // s + 1, (y.shape[2] - k) // s + 1
    acc = b.expand(y.shape[0], oh, ow, -1).clone()
    for i in range(k):
        for j in range(k):
            xs = y[:, i:i + (oh - 1) * s + 1:s, j:j + (ow - 1) * s + 1:s]
            for c in range(y.shape[3]):
                acc = acc + xs[..., c:c + 1] * w[i, j, c]
    return _ACTS[l.activation](acc.double()).float()


def ordered_whole(x, ws, bs, plan):
    """Every layer of ``plan`` over the whole frame, SAME padding, through
    :func:`ordered_layer`."""
    y = x
    for l, w, b in zip(plan.layers, ws, bs):
        y = torch.nn.functional.pad(y, (0, 0, l.pad_left, l.pad_right,
                                        l.pad_top, l.pad_bottom))
        y = ordered_layer(y, w, b, l)
    return y


def _origin(t, org):
    return t * org[0] - org[1]


def emulate(x, ws, bs, plan, tp, *, layer=plain_layer, head_w=None,
            head_b=None, zero_edges=True):
    """The kernels' tiling on the CPU: every tile's regions through
    ``layer``, stitched back; with ``head_w``, also the projection summed
    over each of a tile's ``head_parts`` runs of features, then over the
    (tile, run) pairs in order."""
    B = x.shape[0]
    feats = torch.full((B,) + plan.feature_shape, float("nan"))
    partials = []
    for ty in range(tp.tiles_y):
        for tx in range(tp.tiles_x):
            y = _region(x, _origin(ty, tp.in_org_h), _origin(tx, tp.in_org_w),
                        tp.in_ext_h, tp.in_ext_w)
            for l, lt, w, b in zip(plan.layers, tp.layers, ws, bs):
                y = layer(y, w, b, l)
                assert tuple(y.shape[1:3]) == (lt.ext_h, lt.ext_w)
                if zero_edges:
                    rows = _origin(ty, lt.org_h) + torch.arange(lt.ext_h)
                    cols = _origin(tx, lt.org_w) + torch.arange(lt.ext_w)
                    inside = (((rows >= 0) & (rows < l.out_h))[:, None]
                              & ((cols >= 0) & (cols < l.out_w))[None, :])
                    y = torch.where(inside[None, :, :, None], y,
                                    torch.zeros(()))
            gy, gx = ty * tp.tile_h, tx * tp.tile_w
            assert (_origin(ty, tp.layers[-1].org_h),
                    _origin(tx, tp.layers[-1].org_w)) == (gy, gx)
            vh = min(tp.tile_h, plan.out_h - gy)
            vw = min(tp.tile_w, plan.out_w - gx)
            feats[:, gy:gy + vh, gx:gx + vw] = y[:, :vh, :vw]
            if head_w is not None:
                rows = [((gy + py) * plan.out_w + gx + px) * plan.k_out + c
                        for py in range(vh) for px in range(vw)
                        for c in range(plan.k_out)]
                flat = y[:, :vh, :vw].reshape(B, -1)
                parts = head_parts(head_w.shape[1])
                for part in range(parts):
                    e0 = part * len(rows) // parts
                    e1 = (part + 1) * len(rows) // parts
                    partials.append(flat[:, e0:e1] @ head_w[rows[e0:e1]])
    if head_w is None:
        return feats
    z = head_b.expand(B, -1).clone()
    for part in partials:
        z = z + part
    return feats, torch.relu(z)


def _case(spec, B, h, w, D=None, seed=0):
    rng = np.random.default_rng(seed)
    jparams = j_miniconv.miniconv_init(jax.random.PRNGKey(seed),
                                       _jspec(spec))
    params = params_from_jax(jparams, device="cpu")
    ws = [params[f"layer{i}"]["kernel"] for i in range(len(spec.layers))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, l.c_out).astype(np.float32))
          for l in spec.layers]
    for i, b in enumerate(bs):
        params[f"layer{i}"]["bias"] = b
        jparams[f"layer{i}"]["bias"] = jnp.asarray(b.numpy())
    x = rng.random((B, h, w, spec.layers[0].c_in), dtype=np.float32)
    hw = hb = None
    if D is not None:
        plan = spec.plan(h, w)
        hw = torch.from_numpy(rng.normal(
            0, 0.05, (plan.flat_features, D)).astype(np.float32))
        hb = torch.from_numpy(rng.normal(0, 0.1, D).astype(np.float32))
    return x, jparams, ws, bs, hw, hb


def _jspec(spec):
    return j_miniconv.MiniConvSpec(tuple(
        j_miniconv.LayerSpec(l.kernel, l.stride, l.c_in, l.c_out,
                             l.activation) for l in spec.layers))


@pytest.mark.parametrize("c_in,h,t,want", [
    (12, 84, 4, (40, 19, 9, 4)),       # 8T+8, 4T+3, 2T+1, T
    (12, 84, 2, (24, 11, 5, 2)),
    (4, 400, 6, (56, 27, 13, 6)),
    (4, 400, 5, (48, 23, 11, 5)),
])
def test_halo_extents_of_the_standard_spec(c_in, h, t, want):
    plan = standard_spec(c_in=c_in, k=4).plan(h)
    tp = t_passplan.tile_layout(plan, t, t)
    got = (tp.in_ext_h,) + tuple(lt.ext_h for lt in tp.layers)
    assert got == want
    assert (tp.in_ext_w,) + tuple(lt.ext_w for lt in tp.layers) == want
    assert tp.tiles_y == tp.tiles_x == -(-plan.out_h // t)


def test_region_bytes_of_a_400x400_tile():
    """T=6 at 400x400x4: input 56x56x4, layer 0 27x27x16, layer 1 13x13x16
    (107,648 B), each row padded to an even width for the stride-2 layer
    that reads it (110,208 B); K4 adds three more frames' tile slots, and
    passes of two frames one more input region and one more of each
    layer's."""
    plan = standard_spec(c_in=4, k=4).plan(400)
    k1 = t_passplan.tile_layout(plan, 6, 6)
    k4 = t_passplan.tile_layout(plan, 6, 6, streamed=True)
    k4x2 = t_passplan.tile_layout(plan, 6, 6, streamed=True, frames=2)
    assert 4 * (56 * 56 * 4 + 27 * 27 * 16 + 13 * 13 * 16) == 107_648
    assert (k1.in_row, k1.layers[0].row, k1.layers[1].row) == (56, 28, 14)
    regions = 4 * (56 * 56 * 4 + 27 * 28 * 16 + 13 * 14 * 16)
    assert regions == 110_208
    weights = 4 * sum(l.kernel ** 2 * l.c_in * lt.co_pad + lt.co_pad
                      for l, lt in zip(plan.layers, k1.layers))
    slot = 4 * 6 * 6 * 4
    assert k1.smem_bytes == regions + weights + slot
    assert k4.group == t_passplan.FRAMES_PER_ITEM == 4 and k1.group == 1
    assert k4.frames == 1
    assert k4.smem_bytes - k1.smem_bytes == 3 * slot
    assert k4x2.frames == 2
    assert [lt.co_pad for lt in k4x2.layers] == \
        [lt.co_pad for lt in k1.layers]
    assert k4x2.smem_bytes - k1.smem_bytes == regions + 3 * slot
    assert k1.n_tiles == 81


@pytest.mark.parametrize("spec,h,w,t", [
    (ODD, 85, 83, 4), (ONE, 17, 23, 4), (standard_spec(), 84, 84, 3)])
def test_region_origins_walk_back_through_each_layer(spec, h, w, t):
    """A layer's input region starts where the previous layer's output
    region starts, at the output origin times the stride less the top
    (left) padding; the first tile's input starts at minus the padding
    the whole chain adds."""
    plan = spec.plan(h, w)
    tp = t_passplan.tile_layout(plan, t, t)
    ins = [tp.in_org_h] + [lt.org_h for lt in tp.layers[:-1]]
    for ty in range(tp.tiles_y):
        for l, lt, org_in in zip(plan.layers, tp.layers, ins):
            assert (_origin(ty, lt.org_h) * l.stride - l.pad_top
                    == _origin(ty, org_in))
            assert (lt.ext_h - 1) * l.stride + l.kernel == (
                tp.in_ext_h if org_in is tp.in_org_h
                else tp.layers[l.index - 1].ext_h)
    assert tp.layers[-1].org_h == (t, 0) and tp.layers[-1].org_w == (t, 0)
    pad = 0
    for l in reversed(plan.layers):
        pad = pad * l.stride + l.pad_top
    assert _origin(0, tp.in_org_h) == -pad


STITCH = [  # (label, spec, B, h, w, tile or None for the plan's choice, D)
    ("84 served", standard_spec(), 1, 84, 84, None, None),
    ("84 batch", standard_spec(), 8, 84, 84, None, 32),
    ("84 T=4", standard_spec(), 2, 84, 84, 4, 32),
    ("400 T=6", standard_spec(c_in=4), 1, 400, 400, 6, None),
    ("odd T=4", ODD, 2, 85, 83, 4, 20),
    ("odd", ODD, 3, 85, 83, None, None),
    ("one-layer", ONE, 2, 17, 23, None, 12),
    ("one-layer T=5", ONE, 1, 17, 23, 5, None),
]


@pytest.mark.parametrize("label,spec,B,h,w,t,D", STITCH,
                         ids=[c[0] for c in STITCH])
def test_tiles_stitch_to_the_whole_frame_bit_for_bit(label, spec, B, h, w,
                                                     t, D):
    x, jparams, ws, bs, hw, hb = _case(spec, B, h, w, D)
    plan = spec.plan(h, w)
    tp = plan.tile_plan(B) if t is None else t_passplan.tile_layout(
        plan, t, t)
    xt = torch.from_numpy(x)
    assert torch.equal(emulate(xt, ws, bs, plan, tp, layer=ordered_layer),
                       ordered_whole(xt, ws, bs, plan))
    got = emulate(xt, ws, bs, plan, tp, head_w=hw, head_b=hb)
    whole = miniconv_encoder_ref(xt, ws, bs, plan, head_w=hw, head_b=hb)
    if D is None:
        got, whole = (got, None), (whole, None)
    torch.testing.assert_close(got[0], whole[0], atol=1e-6, rtol=1e-6)
    if D is not None:
        torch.testing.assert_close(got[1], whole[1], atol=Z_TOL, rtol=Z_TOL)
    want = np.asarray(j_miniconv.miniconv_apply(jparams, _jspec(spec),
                                                jnp.asarray(x)))
    np.testing.assert_allclose(got[0].numpy(), want, atol=FEAT_TOL,
                               rtol=FEAT_TOL)


@pytest.mark.parametrize("spec,h,w,t", [(ODD, 85, 83, 4),
                                        (standard_spec(), 84, 84, 4)])
def test_edges_computed_from_padding_would_differ(spec, h, w, t):
    """The trap the kernels avoid: a region's positions outside its layer
    computed from zero input carry bias plus activation, not zero."""
    x, _, ws, bs, _, _ = _case(spec, 1, h, w)
    plan = spec.plan(h, w)
    tp = t_passplan.tile_layout(plan, t, t)
    xt = torch.from_numpy(x)
    wrong = emulate(xt, ws, bs, plan, tp, zero_edges=False)
    assert not torch.allclose(wrong, miniconv_encoder_ref(xt, ws, bs, plan),
                              atol=FEAT_TOL, rtol=FEAT_TOL)


def test_task_shapes_fill_the_threads_and_reuse_loads():
    """A large stride-2 region takes the biggest register tile (2 pixels x
    8 channels: 4 loads per 16 FMAs); a region smaller than the block
    takes a smaller tile to keep the threads busy; no shape pads a 4-wide
    output past 4 channels."""
    std = standard_spec(c_in=4).plan(400)
    l0, l2 = std.layers[0], std.layers[2]
    assert t_passplan.task_shape(27 * 27, l0) == (2, 8)
    assert t_passplan.task_shape(7 * 7, l0)[0] * \
        t_passplan.task_shape(7 * 7, l0)[1] <= 8
    for n in (1, 36, 400):
        assert t_passplan.task_shape(n, l2)[1] == 4
    for n in (1, 9, 100, 1000):
        assert t_passplan.task_shape(n, l0) in t_passplan.TASK_SHAPES


@pytest.mark.parametrize("c_in,h,B,min_tiles", [(12, 84, 1, 36),
                                                (4, 400, 64, 100)])
def test_tile_plan_spreads_a_launch_over_the_card(c_in, h, B, min_tiles):
    """B=1 at 84x84 spreads one frame over many SMs; a batch of 64 at
    400x400 keeps the tile large (little recompute) and still fills every
    SM many times over."""
    plan = standard_spec(c_in=c_in).plan(h)
    tp = plan.tile_plan(B, streamed=True)
    assert tp.n_tiles >= min_tiles
    if B > 1:
        assert B * tp.n_tiles >= 10 * t_passplan.N_SMS
        assert tp.recompute(plan) < 1.5
    assert plan.tile_plan(B).tile_h == tp.tile_h    # K1 cuts as K4 does


@pytest.mark.parametrize("n_pix,frames", [(121, 1), (121, 2), (225, 1),
                                          (9, 4), (25, 3), (529, 2)])
def test_pass_tasks_cover_each_frames_outputs_once(n_pix, frames):
    """The kernels' task numbering of a layer pass (``conv_region``): the
    pass's frames' pixels one frame after the other, cut into groups of
    ``pix`` pixels ``groups`` apart, times the channel blocks, reaches
    every (frame, pixel, channel) once, whatever register tile the plan
    chooses for it."""
    l0 = standard_spec().plan(84).layers[0]
    for pix, cb in t_passplan.TASK_SHAPES:
        co_pad = -(-l0.c_out // cb) * cb
        total = frames * n_pix
        groups = -(-total // pix)
        seen = []
        for task in range(groups * (co_pad // cb)):
            blk, g = divmod(task, groups)
            for k in range(pix):
                px = g + k * groups
                if px < total:
                    f, lp = divmod(px, n_pix)
                    seen += [(f, lp, blk * cb + q) for q in range(cb)
                             if blk * cb + q < l0.c_out]
        assert sorted(seen) == [(f, p, c) for f in range(frames)
                                for p in range(n_pix)
                                for c in range(l0.c_out)]
    assert t_passplan.task_shape(frames * n_pix, l0) in t_passplan.TASK_SHAPES


def test_encoder_desc_is_what_the_kernel_reads():
    plan = ODD.plan(85, 83)
    tp = t_passplan.tile_layout(plan, 2, 2, True, frames=2)
    desc = encoder_desc(plan, tp)
    assert len(desc) == 15 + 25 * len(plan.layers)
    assert desc[:5] == [tp.tile_h, tp.tile_w, tp.tiles_y, tp.tiles_x, 4]
    assert desc[12:15] == [tp.in_off, tp.smem_floats, 2]
    mid = desc[15 + 25:15 + 50]
    assert mid[11:15] == [tp.layers[1].ext_h, tp.layers[1].ext_w,
                          tp.layers[1].row, 2]
    last, l2, lt = desc[15 + 25 * 2:], plan.layers[2], tp.layers[2]
    assert last[:11] == [3, 2, 16, 6, 22, 21, 11, 11, l2.pad_top,
                         l2.pad_left, 2]
    assert last[11:] == [tp.tile_h, tp.tile_w, tp.tile_w, 0, tp.tile_h, 0,
                         tp.tile_w, 0, lt.pix, lt.co_block, lt.co_pad,
                         lt.w_off, lt.b_off, lt.out_off]
    k1 = plan.tile_plan(3)                            # K1: one frame
    assert encoder_desc(plan, k1)[4] == 1
    assert encoder_desc(plan, k1)[12:15] == [k1.in_off, k1.smem_floats, 1]
    k4 = plan.tile_plan(3, streamed=True)             # the planner's K4
    assert encoder_desc(plan, k4)[12:15] == [k4.in_off, k4.smem_floats,
                                             k4.frames]


def test_weights_past_shared_memory_are_read_in_place():
    """A layer too wide to stage (4x4x12x320 fp32 = 245,760 B) leaves its
    weights in device memory (w_off -1) and still tiles."""
    wide = MiniConvSpec((LayerSpec(4, 2, 12, 320, "relu"),)).plan(16)
    tp = wide.tile_plan(8)
    assert tp.layers[0].w_off == -1
    assert tp.layers[0].co_pad % tp.layers[0].co_block == 0
    assert tp.smem_bytes + t_passplan.SMEM_STATIC <= t_passplan.SMEM_LIMIT
    assert standard_spec().plan(84).tile_plan(1).layers[0].w_off >= 0


@pytest.mark.parametrize("width,stride,kernel", [(40, 2, 4), (19, 2, 3),
                                                 (9, 2, 3), (25, 1, 3),
                                                 (17, 3, 3)])
def test_phase_split_rows_place_every_column_once(width, stride, kernel):
    """A region row of ``width`` columns read by a stride-s layer stores
    column x at ``(x % s) * (row / s) + x // s``: every column in its own
    place inside the row, and an output column ox's tap j at ``(j % s) *
    (row / s) + ox + j // s``, so neighbouring outputs read neighbouring
    floats."""
    row = t_passplan._split_row(width, stride)
    half = row // stride
    assert row % stride == 0 and width <= row < width + stride
    at = [(x % stride) * half + x // stride for x in range(width)]
    assert len(set(at)) == width and max(at) < row
    for ox in range((width - kernel) // stride + 1):
        for j in range(kernel):
            assert (j % stride) * half + ox + j // stride == \
                at[ox * stride + j]
