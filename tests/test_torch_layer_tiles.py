"""The layer kernels' tile plans (``core.passplan.plan_conv_tiles``), on the
CPU.

K2 and K3 (``kernels/csrc/miniconv_layer.cu``) cut a layer's launch into
blocks of one output tile and a block of output channels; each block
stages the input region under its tile as planes of float4, each row's
columns split by phase modulo the stride, and each thread owns P pixels
by CB channels.  The kernel takes the plan as it is, so its arithmetic
is checked here by emulating the kernel's index arithmetic in numpy:

* every output (frame, row, column, channel) is written by exactly one
  (block, thread, pixel, channel) of the plan;
* every staged read of every output's taps lands on the slot that holds
  the right input value;
* the shared-memory layout fits a block and matches the kernel's;
* the planner spreads the served frame's first layer over at least 64
  blocks and every layer of two 400x400 frames over every SM, and plans
  the shapes the generic instantiation runs;
* the fit of the cost model's constants (``benchmarks/conv_tiles.py``)
  ranks first the model that made a sweep's times.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.core import passplan as pp
from repro_torch.core.miniconv import LayerSpec, MiniConvSpec, standard_spec
from repro_torch.kernels.miniconv_pass import layer_args, tap_stride

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ODD = MiniConvSpec((LayerSpec(4, 2, 12, 16, "relu"),
                    LayerSpec(3, 2, 16, 16, "sigmoid"),
                    LayerSpec(3, 2, 16, 6, "linear")))


def _layers(spec, B, H, W=None):
    """(B, h_out, w_out, kh, kw, stride, c_in, c_out padded to 4) of each
    layer of ``spec`` at (H, W)."""
    plan = spec.plan(H, W)
    return [(B, l.out_h, l.out_w, l.kernel, l.kernel, l.stride, l.c_in,
             l.c_out_pad) for l in plan.layers]


STANDARD = (_layers(standard_spec(c_in=12, k=4), 1, 84)
            + _layers(standard_spec(c_in=12, k=4), 8, 84)
            + _layers(standard_spec(c_in=4, k=4), 2, 400))
GENERIC = (_layers(ODD, 3, 85, 83)
           + [(2, 15, 21, 3, 3, 1, 8, 8), (1, 17, 14, 3, 3, 1, 6, 8),
              (2, 8, 12, 2, 3, 1, 5, 4), (1, 8, 10, 3, 3, 3, 4, 8)])


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def _block_tasks(tp, h_out, w_out):
    """Per block of the plan, per task: the (n, oy, ox, co) each of its
    P x CB accumulators stores (the kernel's mapping), stacked."""
    n_pix = tp.tile_h * tp.tile_w
    groups = -(-n_pix // tp.pix)
    task = np.arange(tp.tasks)
    cb, g = task // groups, task % groups
    px = g[:, None] + np.arange(tp.pix)[None, :] * groups       # (T, P)
    valid = px < n_pix
    py, pxx = px // tp.tile_w, px % tp.tile_w
    blk = np.arange(tp.blocks)
    cob = blk % tp.co_blocks
    rest = blk // tp.co_blocks
    tx = rest % tp.tiles_x
    rest //= tp.tiles_x
    ty, n = rest % tp.tiles_y, rest // tp.tiles_y
    oy = ty[:, None, None] * tp.tile_h + py[None]                # (Bk, T, P)
    ox = tx[:, None, None] * tp.tile_w + pxx[None]
    stored = valid[None] & (oy < h_out) & (ox < w_out)
    co = (cob[:, None, None] * tp.co_block + cb[None, :, None] * tp.cb
          + np.arange(tp.cb)[None, None, :])                     # (Bk, T, CB)
    nn = np.broadcast_to(n[:, None, None], oy.shape)
    return nn, oy, ox, co, stored


@pytest.mark.parametrize("grouped", [True, False], ids=["K3", "K2"])
@pytest.mark.parametrize("shape", STANDARD + GENERIC,
                         ids=_ids(STANDARD + GENERIC))
def test_tiles_write_every_output_exactly_once(shape, grouped):
    B, h_out, w_out, kh, kw, s, c_in, c_out = shape
    c_out = c_out if grouped else 4
    tp = pp.plan_conv_tiles(B, h_out, w_out, kh, kw, s, c_in, c_out, grouped)
    nn, oy, ox, co, stored = _block_tasks(tp, h_out, w_out)
    hits = np.zeros((B, h_out, w_out, c_out), dtype=np.int64)
    sel = np.broadcast_to(stored[..., None], stored.shape + (tp.cb,))
    full = [np.broadcast_to(a[..., None], stored.shape + (tp.cb,))[sel]
            for a in (nn, oy, ox)]
    cos = np.broadcast_to(co[:, :, None, :], stored.shape + (tp.cb,))[sel]
    np.add.at(hits, (full[0], full[1], full[2], cos), 1)
    assert (hits == 1).all()
    assert tp.threads % 32 == 0 and tp.threads <= pp.CONV_MAX_THREADS
    assert tp.threads >= min(tp.tasks, pp.CONV_MAX_THREADS)


def _staged_region(x, tp, n, ty, tx, s):
    """The shared-memory region of block (n, ty, tx) as the kernel stages
    it: c4 planes of in_ext_h rows of in_row float4 slots, column col at
    slot (col % s) * (in_row / s) + col // s; zero past the input."""
    _, h_in, w_in, c_in = x.shape
    reg = np.full((tp.c4, tp.in_ext_h, tp.in_row, 4), np.nan, np.float32)
    half = tp.in_row // s
    iy0, ix0 = ty * tp.tile_h * s, tx * tp.tile_w * s
    for r in range(tp.in_ext_h):
        for col in range(tp.in_ext_w):
            gy, gx = iy0 + r, ix0 + col
            v = np.zeros(4 * tp.c4, np.float32)
            if gy < h_in and gx < w_in:
                v[:c_in] = x[n, gy, gx]
            reg[:, r, (col % s) * half + col // s] = v.reshape(tp.c4, 4)
    return reg


@pytest.mark.parametrize("shape", [(2, 9, 11, 4, 4, 2, 12, 16),
                                   (1, 7, 6, 3, 3, 1, 6, 8),
                                   (1, 5, 7, 3, 3, 3, 5, 4),
                                   (1, 6, 9, 2, 3, 2, 16, 4)],
                         ids=["std-l0", "s1-c6", "s3-c5", "2x3-s2"])
def test_staged_reads_land_on_each_outputs_taps(shape):
    """For a ragged 4x5 tile: every (pixel, i, j, c) read through the
    kernel's base + i * row + (j % s) * half + j // s slot of plane c // 4
    finds x[n, oy * s + i, ox * s + j, c]."""
    B, h_out, w_out, kh, kw, s, c_in, c_out = shape
    h_in, w_in = (h_out - 1) * s + kh, (w_out - 1) * s + kw
    x = np.random.default_rng(0).random((B, h_in, w_in, c_in),
                                        dtype=np.float32)
    tp = pp.conv_tile_layout(B, h_out, w_out, kh, kw, s, c_in, c_out, 4, 5,
                             4, (1, 4))
    half = tp.in_row // s
    for n in range(B):
        for ty in range(tp.tiles_y):
            for tx in range(tp.tiles_x):
                reg = _staged_region(x, tp, n, ty, tx, s)
                for py in range(tp.tile_h):
                    for pxx in range(tp.tile_w):
                        oy, ox = ty * tp.tile_h + py, tx * tp.tile_w + pxx
                        if oy >= h_out or ox >= w_out:
                            continue
                        base = py * s * tp.in_row + pxx
                        for i in range(kh):
                            for j in range(kw):
                                slot = base + i * tp.in_row + (j % s) * half \
                                    + j // s
                                got = reg[:, slot // tp.in_row,
                                          slot % tp.in_row].reshape(-1)
                                np.testing.assert_array_equal(
                                    got[:c_in], x[n, oy * s + i, ox * s + j])


@pytest.mark.parametrize("grouped", [True, False], ids=["K3", "K2"])
@pytest.mark.parametrize("shape", STANDARD + GENERIC,
                         ids=_ids(STANDARD + GENERIC))
def test_shared_memory_fits_and_matches_the_kernels_layout(shape, grouped):
    B, h_out, w_out, kh, kw, s, c_in, c_out = shape
    c_out = c_out if grouped else 4
    tp = pp.plan_conv_tiles(B, h_out, w_out, kh, kw, s, c_in, c_out, grouped)
    assert tp.smem_bytes <= pp.SMEM_LIMIT
    # weights (kh, kw, c_in, co_block) at 0, the bias, the region: the
    # kernel's own arithmetic (miniconv_layer.cu, launch())
    assert tp.b_off == kh * kw * c_in * tp.co_block
    assert tp.in_off == tp.b_off + tp.co_block
    assert tp.in_ext_h == (tp.tile_h - 1) * s + kh
    assert tp.in_ext_w == (tp.tile_w - 1) * s + kw
    assert tp.in_row == s * -(-tp.in_ext_w // s)
    assert tp.smem_floats == tp.in_off + 4 * tp.c4 * tp.in_ext_h * tp.in_row
    assert tp.in_off % 4 == 0                    # 16-byte aligned region
    assert c_out % tp.co_block == 0 and tp.co_block % tp.cb == 0
    shapes = pp.TASK_SHAPES if grouped else pp.PASS_TASK_SHAPES
    assert (tp.pix, tp.cb) in shapes


@pytest.mark.parametrize("grouped", [True, False], ids=["K3", "K2"])
def test_block_counts_spread_over_the_card(grouped):
    """The served frame's first layer over at least 64 blocks (7 before
    the redesign), and every layer of two 400x400 frames over at least
    the 132 SMs."""
    def blocks(layer):
        B, h_out, w_out, kh, kw, s, c_in, c_out = layer
        return pp.plan_conv_tiles(B, h_out, w_out, kh, kw, s, c_in,
                                  c_out if grouped else 4, grouped).blocks
    served = _layers(standard_spec(c_in=12, k=4), 1, 84)
    assert blocks(served[0]) >= 64
    for layer in _layers(standard_spec(c_in=4, k=4), 2, 400):
        assert blocks(layer) >= pp.N_SMS


@pytest.mark.parametrize("shape", GENERIC, ids=_ids(GENERIC))
def test_planner_plans_the_generic_shapes(shape):
    B, h_out, w_out, kh, kw, s, c_in, c_out = shape
    for grouped in (True, False):
        tp = pp.plan_conv_tiles(B, h_out, w_out, kh, kw, s, c_in,
                                c_out if grouped else 4, grouped)
        assert tp.blocks >= 1 and tp.cost > 0


def test_planner_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="c_out % 4"):
        pp.plan_conv_tiles(1, 8, 8, 3, 3, 1, 8, 6)
    with pytest.raises(ValueError, match="4 channels"):
        pp.plan_conv_tiles(1, 8, 8, 3, 3, 1, 8, 8, False)
    with pytest.raises(ValueError, match="shared memory"):
        pp.plan_conv_tiles(1, 8, 8, 3, 3, 1, 8000, 4)


def test_tap_stride_reads_group_views_in_place():
    w = torch.zeros(4, 3, 12, 16)
    assert tap_stride(w) == 16
    assert tap_stride(w[..., 8:12]) == 16            # a group view
    assert tap_stride(w[:, :, :1, 4:8]) == 0         # copied
    assert tap_stride(torch.zeros(1, 1, 1, 4)) == 4
    assert tap_stride(w.permute(0, 1, 3, 2)) == 0    # strided channels
    assert tap_stride(w[:, :2]) == 0                 # taps not one stride
    assert tap_stride(w[..., ::2]) == 0


def test_layer_args_are_what_the_kernel_reads():
    """The int64 array in ``enum Arg`` order (miniconv_layer.cu): its 25
    slots but the device and stream, which ``_build.launch`` appends; the
    plan's as the kernel's layout check expects them."""
    w = torch.zeros(3, 3, 16, 16)[..., 4:8]
    tp = pp.plan_conv_tiles(2, 11, 11, 3, 3, 2, 16, 4, False)
    args = layer_args((11, 12, 13, 14), (2, 23, 23, 16, 3, 3, 2, 11, 11, 4),
                      tap_stride(w), tp, False)
    assert list(args) == [
        11, 12, 13, 14, 2, 23, 23, 16, 3, 3, 2, 11, 11, 4, 16, tp.tile_h,
        tp.tile_w, tp.co_block, tp.pix, tp.cb, tp.threads, tp.smem_bytes, 0]
    assert tp.launch_ints == (tp.tile_h, tp.tile_w, tp.co_block, tp.pix,
                              tp.cb, tp.threads, tp.smem_bytes)


def test_cost_model_fit_finds_the_model_that_made_the_times():
    """``conv_tiles --fit`` over a sweep whose times are the shipped
    model's own costs ranks that model first: its picks are the fastest
    plans a pick may be, and ``pick_conv_plan`` is the planner's rule."""
    from repro_torch.benchmarks.conv_tiles import fit
    B, h_out, w_out, k, s, c_in, c_out = 1, 11, 11, 3, 2, 16, 4
    cands = pp.conv_candidates(B, h_out, w_out, k, k, s, c_in, c_out)
    assert (pp.pick_conv_plan(cands)
            == pp.plan_conv_tiles(B, h_out, w_out, k, k, s, c_in, c_out))
    rows = [dict(kernel="K3", shape=[B, h_out, w_out, c_out],
                 kernel_size=k, stride=s, c_in=c_in,
                 plans=[dict(tile_h=tp.tile_h, tile_w=tp.tile_w,
                             co_block=tp.co_block, pix=tp.pix, cb=tp.cb,
                             us=tp.cost) for tp in cands])]
    ranked = fit(rows)
    assert ranked[0][2] == pp.CONV_COST
    assert [m for _, _, m in ranked].count(pp.CONV_COST) == 1
    assert all(a[0] <= b[0] for a, b in zip(ranked, ranked[1:]))
