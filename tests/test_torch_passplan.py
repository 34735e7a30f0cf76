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


def test_shared_memory_residency_model():
    """The port's residency model: a launch is cut into halo tiles, every
    layer's region of a tile in its block's shared memory, and
    max_safe_batch is the frames that fill one wave of the streamed
    kernel's resident blocks."""
    p84 = t_miniconv.standard_spec(c_in=12, k=4).plan(84)
    k4 = p84.tile_plan(8, streamed=True)
    k1 = p84.tile_plan(8)
    # K1 and K4 cut alike; K4 holds a second input buffer
    assert (k1.tile_h, k1.tile_w) == (k4.tile_h, k4.tile_w)
    assert len(k1.in_offs) == 1 and len(k4.in_offs) == 2
    slot = k4.tile_h * k4.tile_w * 4
    assert k4.smem_bytes - k1.smem_bytes == 4 * (
        k4.in_ext_h * k4.in_row * 12 + (k4.group - 1) * slot)
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
    offs = [*tp.in_offs] + [o for lt in tp.layers
                            for o in (lt.w_off, lt.b_off, lt.out_off)]
    assert all(o % 4 == 0 for o in offs)
