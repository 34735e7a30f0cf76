"""The port's spec, plan and backend registry against the reference.

Plan arithmetic is exact integer work, so every comparison here is
equality: the same LayerPlan/ShaderPass tuples, feature bytes, FLOPs and
HeadPlan as ``repro.core.passplan``, over the analysis grid (c_in=12 at
X=84; c_in=4 at X=64/128/256/400) and odd, non-square inputs.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import backends as j_backends
from repro.core import passplan as j_passplan
from repro.core import miniconv as j_miniconv
from repro_torch.core import backends as t_backends
from repro_torch.core import passplan as t_passplan
from repro_torch.core import miniconv as t_miniconv

GRID = [(12, 84, 84)] + [(4, x, x) for x in (64, 128, 256, 400)] \
    + [(12, 83, 59), (4, 85, 83)]


def _plans(c_in, h, w, k):
    jp = j_miniconv.standard_spec(c_in=c_in, k=k).plan(h, w)
    tp = t_miniconv.standard_spec(c_in=c_in, k=k).plan(h, w)
    return jp, tp


@pytest.mark.parametrize("c_in,h,w", GRID)
@pytest.mark.parametrize("k", [4, 16])
def test_plan_records_equal_reference(c_in, h, w, k):
    jp, tp = _plans(c_in, h, w, k)
    assert ([dataclasses.astuple(l) for l in tp.layers]
            == [dataclasses.astuple(l) for l in jp.layers])
    assert ([dataclasses.astuple(p) for p in tp.passes]
            == [dataclasses.astuple(p) for p in jp.passes])
    for tl, jl in zip(tp.layers, jp.layers):
        assert (tl.n_groups, tl.c_in_pad, tl.c_out_pad, tl.padded_in_h,
                tl.padded_in_w, tl.flops) == \
            (jl.n_groups, jl.c_in_pad, jl.c_out_pad, jl.padded_in_h,
             jl.padded_in_w, jl.flops)
    for tps, jps in zip(tp.passes, jp.passes):
        assert (tps.texture_bindings, tps.samples, tps.flops) == \
            (jps.texture_bindings, jps.samples, jps.flops)


@pytest.mark.parametrize("c_in,h,w", GRID)
@pytest.mark.parametrize("k", [4, 16])
def test_plan_totals_and_head_equal_reference(c_in, h, w, k):
    jp, tp = _plans(c_in, h, w, k)
    for attr in ("out_h", "out_w", "k_out", "feature_shape", "total_passes",
                 "feature_bytes", "flat_features", "flops_per_frame",
                 "max_pass_samples"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for d, act in ((512, "relu"), (200, "sigmoid")):
        th, jh = tp.head(d, act), jp.head(d, act)
        assert dataclasses.astuple(th) == dataclasses.astuple(jh)
        assert (th.flops, th.param_bytes) == (jh.flops, jh.param_bytes)
        assert tp.flops_per_batch(8, th) == jp.flops_per_batch(8, jh)
    assert tp.flops_per_batch(3) == jp.flops_per_batch(3)


@pytest.mark.parametrize("k", [4, 16])
def test_spec_derived_quantities_equal_reference(k):
    js = j_miniconv.standard_spec(c_in=12, k=k)
    ts = t_miniconv.standard_spec(c_in=12, k=k)
    assert ([dataclasses.astuple(l) for l in ts.layers]
            == [dataclasses.astuple(l) for l in js.layers])
    assert dataclasses.astuple(ts.budget) == dataclasses.astuple(js.budget)
    assert (ts.k_out, ts.n_stride2, ts.total_passes) == \
        (js.k_out, js.n_stride2, js.total_passes)
    for x in (84, 100, 400):
        assert ts.out_spatial(x) == js.out_spatial(x)
        assert ts.feature_bytes(x) == js.feature_bytes(x)
        assert ts.flops_per_frame(x) == js.flops_per_frame(x)


def test_spatial_primitives_equal_reference():
    for size in range(1, 130):
        for kernel in (1, 3, 4, 5, 8):
            for stride in (1, 2, 3):
                assert t_passplan.same_pads(size, kernel, stride) == \
                    j_passplan.same_pads(size, kernel, stride)
        assert t_passplan.out_size(size, 2) == j_passplan.out_size(size, 2)
        assert t_passplan.out_spatial_chain(size, (2, 2, 1, 2)) == \
            j_passplan.out_spatial_chain(size, (2, 2, 1, 2))


@pytest.mark.parametrize("layers", [
    ((5, 2, 12, 16),),            # 5x5 x 3 textures = 75 samples > 64
    ((3, 1, 36, 4),),             # 36 channels > 8 textures x 4
])
def test_budget_violations_raise_in_both(layers):
    for mod in (j_miniconv, t_miniconv):
        spec = mod.MiniConvSpec(tuple(mod.LayerSpec(*l) for l in layers))
        with pytest.raises(ValueError, match="budget"):
            spec.validate()
        with pytest.raises(ValueError, match="budget"):
            spec.plan(32)


def test_chained_channel_mismatch_raises():
    spec = t_miniconv.MiniConvSpec((t_miniconv.LayerSpec(3, 2, 4, 8),
                                    t_miniconv.LayerSpec(3, 2, 4, 4)))
    with pytest.raises(ValueError, match="c_in 4 != previous c_out 8"):
        spec.validate()


def test_backend_registry_resolves_like_reference():
    assert t_backends.backend_names() == j_backends.backend_names()
    assert (t_backends.backend_names(include_aliases=True)
            == j_backends.backend_names(include_aliases=True))
    for name in (*j_backends.backend_names(include_aliases=True),
                 False, None, True):
        tb, jb = t_backends.get_backend(name), j_backends.get_backend(name)
        assert (tb.name, tb.mode, tb.fused_head, tb.streamed) == \
            (jb.name, jb.mode, jb.fused_head, jb.streamed), name
    for bad in ("nope", 3):
        with pytest.raises(ValueError, match="registered"):
            t_backends.get_backend(bad)


def _smem_floats(plan, tp):
    """A tile layout's shared memory, from its parts: each layer's staged
    weights and bias; one input buffer of ``frames`` frames; each
    intermediate region of ``frames`` frames; the last layer's slot of
    each of an item's ``group`` frames; each part 16-byte aligned."""
    def r4(n):
        return -(-n // 4) * 4
    weights = sum(r4(l.kernel ** 2 * l.c_in * lt.co_pad) + r4(lt.co_pad)
                  for l, lt in zip(plan.layers, tp.layers))
    inputs = r4(tp.frames * tp.in_ext_h * tp.in_row * plan.layers[0].c_in)
    mid = sum(r4(tp.frames * lt.ext_h * lt.row * l.c_out)
              for l, lt in zip(plan.layers[:-1], tp.layers[:-1]))
    return weights + inputs + mid + r4(tp.group * tp.tile_h * tp.tile_w
                                       * plan.k_out)


def test_shared_memory_residency_model():
    """The port's residency model: a launch is cut into halo tiles, every
    layer's region of a tile in its block's shared memory, and
    max_safe_batch is the frames that fill one wave of the streamed
    kernel's resident blocks."""
    p84 = t_miniconv.standard_spec(c_in=12, k=4).plan(84)
    k4 = p84.tile_plan(8, streamed=True)
    k1 = p84.tile_plan(8)
    # K1 and K4 cut alike; each holds one input buffer, K1's of one frame
    # and K4's of a pass's frames, each region a pass's frames and a slot
    # for each of its item's frames
    assert (k1.tile_h, k1.tile_w) == (k4.tile_h, k4.tile_w)
    assert (k1.frames, k1.group) == (1, 1)
    assert k1.smem_floats == _smem_floats(p84, k1)
    assert k4.smem_floats == _smem_floats(p84, k4)
    one = t_passplan.tile_layout(p84, k4.tile_h, k4.tile_w, True)
    slot = k4.tile_h * k4.tile_w * 4
    assert one.smem_bytes - k1.smem_bytes == 4 * (k4.group - 1) * slot
    two = t_passplan.tile_layout(p84, k4.tile_h, k4.tile_w, True, frames=2)
    assert two.layers[0].out_off - two.in_off == 2 * two.in_ext_h * \
        two.in_row * 12
    assert two.smem_floats == _smem_floats(p84, two)
    assert k4.smem_bytes + t_passplan.SMEM_STATIC <= t_passplan.SMEM_LIMIT
    assert p84.max_safe_batch() >= 8          # max_batch=8 is never refused
    p400 = t_miniconv.standard_spec(c_in=4, k=4).plan(400)
    wave = p400.tile_plan(None, streamed=True)
    assert p400.max_safe_batch() == \
        wave.group * -(-wave.resident_blocks // wave.n_tiles)
    assert 1 <= p400.max_safe_batch() < 64    # config B streams
    one = t_miniconv.MiniConvSpec(
        (t_miniconv.LayerSpec(3, 1, 4, 6),)).plan(17, 23)
    assert len(one.tile_plan(1).layers) == 1
    odd = t_miniconv.MiniConvSpec((t_miniconv.LayerSpec(3, 2, 4, 6),
                                   t_miniconv.LayerSpec(3, 2, 6, 16),
                                   t_miniconv.LayerSpec(3, 1, 16, 5)))
    # buffers start 16-byte aligned: offsets are multiples of 4 floats
    tp = odd.plan(33, 19).tile_plan(3, streamed=True)
    offs = [tp.in_off] + [o for lt in tp.layers
                          for o in (lt.w_off, lt.b_off, lt.out_off)]
    assert all(o % 4 == 0 for o in offs)


@pytest.mark.parametrize("c_in,side,batch", [(12, 84, 256), (12, 84, None),
                                             (4, 400, 64), (4, 400, None)])
def test_streamed_plans_of_the_benchmark_shapes_fit_two_blocks(c_in, side,
                                                               batch):
    """K4's plan at the benchmark's shapes (and for throughput) keeps two
    blocks on an SM, and its descriptor carries its one input buffer and
    the frames of a pass."""
    from repro_torch.kernels.miniconv_pass import encoder_desc
    plan = t_miniconv.standard_spec(c_in=c_in, k=4).plan(side)
    tp = plan.tile_plan(batch, streamed=True)
    assert tp.blocks_per_sm == t_passplan.MAX_BLOCKS_PER_SM == 2
    assert 1 <= tp.frames <= tp.group and tp.group % tp.frames == 0
    assert encoder_desc(plan, tp)[12:15] == [tp.in_off, tp.smem_floats,
                                             tp.frames]


def test_first_layer_pass_fills_the_block_at_84x84x12():
    """At 84x84x12 the streamed plan's first layer fills most of the
    block's threads (the plan before passes and one-buffer layouts, 2x2
    tiles a frame at a time, filled 122 of 256), and a frame takes fewer
    passes than its 36 tiles of that plan."""
    plan = t_miniconv.standard_spec(c_in=12, k=4).plan(84)
    for batch in (256, None):
        tp = plan.tile_plan(batch, streamed=True)
        l0, lt = plan.layers[0], tp.layers[0]
        tasks = (-(-tp.frames * lt.ext_h * lt.ext_w // lt.pix)
                 * (lt.co_pad // lt.co_block))
        threads = t_passplan.ENCODER_THREADS
        assert tasks / (-(-tasks // threads) * threads) >= 0.85
        assert tp.n_passes(tp.group) / tp.group < 36
        assert l0.c_out == 16


@pytest.mark.parametrize("c_in,side", [(12, 84), (9, 84), (4, 128),
                                       (4, 400)])
def test_k1_plans_take_one_frame_a_pass_and_k4s_tile(c_in, side):
    """K1 runs one frame a pass at every batch, at the tile size K4 takes
    at that batch."""
    plan = t_miniconv.standard_spec(c_in=c_in, k=4).plan(side)
    for batch in (1, 2, 3, 8, 13, 33, 64, 256):
        k1, k4 = plan.tile_plan(batch), plan.tile_plan(batch, streamed=True)
        assert (k1.frames, k1.group) == (1, 1)
        assert (k1.tile_h, k1.tile_w) == (k4.tile_h, k4.tile_w)
