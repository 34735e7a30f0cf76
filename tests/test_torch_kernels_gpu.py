"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a Hopper card and nvcc: the ``cuda`` fixture skips every test here
otherwise (decided at run time, never at import).  On the machine with the
card, from the root of a checkout::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: the shared conftest imports JAX, which that machine
does not have.)  TF32 is switched off so that the plain versions compute
in full fp32.  Tolerances: features 1e-5 and projections 1e-4, the
kernels summing in another order than cuDNN and cuBLAS; K5 2e-4 in f32,
and 1e-2 in bf16 against the plain version in f32 on the upcast inputs
(the kernel rounds P to bf16 for its tensor-core product, and its output).
"""
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.core.miniconv import (LayerSpec, MiniConvSpec,
                                       miniconv_apply, miniconv_init,
                                       standard_spec)
from repro_torch.kernels import cuda_kernels_supported
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import miniconv_pass as kmod
from repro_torch.kernels.ops import same_pad
from repro_torch.kernels.ref import (attention_ref, miniconv_encoder_ref,
                                     miniconv_layer_grouped_ref,
                                     miniconv_pass_ref)
from repro_torch.nn import attention as t_attn

pytestmark = pytest.mark.gpu

FEAT_TOL = 1e-5
Z_TOL = 1e-4


@pytest.fixture
def cuda():
    if not cuda_kernels_supported():
        pytest.skip("needs a Hopper (sm_90) card and nvcc: the port's CUDA "
                    "kernels build and run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(spec, B, H, W, D, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = miniconv_init(gen, spec, device=dev)
    ws = [params[f"layer{i}"]["kernel"] for i in range(len(spec.layers))]
    bs = [(torch.randn(l.c_out, generator=gen) * 0.1).to(dev)
          for l in spec.layers]
    x = torch.rand((B, H, W, spec.layers[0].c_in), generator=gen).to(dev)
    plan = spec.plan(H, W)
    hw = hb = None
    if D is not None:
        hw = (torch.randn(plan.flat_features, D, generator=gen) * 0.05).to(dev)
        hb = (torch.randn(D, generator=gen) * 0.1).to(dev)
    return plan, x, ws, bs, hw, hb


ODD = MiniConvSpec((LayerSpec(4, 2, 12, 16, "relu"),
                    LayerSpec(3, 2, 16, 16, "sigmoid"),
                    LayerSpec(3, 2, 16, 6, "linear")))


@pytest.mark.parametrize("spec,B,H,W,D,min_tiles", [
    (standard_spec(c_in=12, k=4), 8, 84, 84, None, 9),
    (standard_spec(c_in=12, k=4), 8, 84, 84, 512, 9),
    (standard_spec(c_in=4, k=4), 2, 128, 128, 512, 16),
    (ODD, 3, 85, 83, 200, 9),
    (MiniConvSpec((LayerSpec(3, 1, 8, 6, "sigmoid"),)), 2, 17, 23, 40, 2),
    (standard_spec(c_in=12, k=4), 1, 84, 84, None, 36),
    (standard_spec(c_in=12, k=4), 1, 84, 84, 512, 36),
    (MiniConvSpec((LayerSpec(4, 2, 12, 320, "relu"),)), 2, 16, 16, 24, 1),
], ids=["std", "std+head", "global+head", "odd+head", "one-layer+head",
        "served", "served+head", "wide+head"])
def test_encoder_kernel_matches_plain(cuda, spec, B, H, W, D, min_tiles):
    """K1 at each shape, cut into at least ``min_tiles`` tiles a frame
    (one frame at 84x84 spreads over many SMs); the batched 84x84 and odd
    cases take tiles that do not divide their 11x11 output; the wide layer's
    weights (245,760 B) miss shared memory and are read in place."""
    plan, x, ws, bs, hw, hb = _case(spec, B, H, W, D, cuda)
    tp = plan.tile_plan(B)
    assert tp.n_tiles >= min_tiles
    if H in (84, 85) and B > 1:
        assert plan.out_h % tp.tile_h != 0
    before = kmod.miniconv_encoder.launches
    got = kmod.miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb)
    want = miniconv_encoder_ref(x, ws, bs, plan, head_w=hw, head_b=hb)
    torch.cuda.synchronize()
    assert kmod.miniconv_encoder.launches == before + 1
    if D is None:
        got, want = (got, None), (want, None)
    torch.testing.assert_close(got[0], want[0], atol=FEAT_TOL, rtol=FEAT_TOL)
    if D is not None:
        torch.testing.assert_close(got[1], want[1], atol=Z_TOL, rtol=Z_TOL)
    again = kmod.miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb)
    again = again if D is not None else (again, None)
    assert torch.equal(got[0], again[0])            # repeats bit for bit
    assert D is None or torch.equal(got[1], again[1])


@pytest.mark.parametrize("B,H,c_in", [(4, 84, 12), (2, 400, 4)])
def test_pass_kernel_matches_plain_on_every_standard_layer(cuda, B, H, c_in):
    """K2 on each 4-channel group view of every standard layer, at 84x84
    and 400x400: within 1e-5 of the plain version, nothing copied, the
    same bits on a second run."""
    spec = standard_spec(c_in=c_in, k=4)
    plan, x, ws, bs, _, _ = _case(spec, B, H, H, None, cuda)
    y = x
    kmod.miniconv_pass.copies = 0
    for l, w, b in zip(plan.layers, ws, bs):
        xp = same_pad(y, l.kernel, l.stride)
        for g in range(0, l.c_out, 4):
            wg = torch.nn.functional.pad(w, (0, (-l.c_out) % 4))[..., g:g + 4]
            bg = torch.nn.functional.pad(b, (0, (-l.c_out) % 4))[g:g + 4]
            got = kmod.miniconv_pass(xp, wg, bg, stride=l.stride)
            want = miniconv_pass_ref(xp, wg, bg, stride=l.stride)
            torch.testing.assert_close(got, want, atol=FEAT_TOL,
                                       rtol=FEAT_TOL)
            assert torch.equal(got, kmod.miniconv_pass(xp, wg, bg,
                                                       stride=l.stride))
        y = torch.relu(miniconv_pass_ref(xp, w, b, stride=l.stride))
    assert kmod.miniconv_pass.copies == 0


# (kh, kw, stride, c_in, c_out, B, H_in, W_in): the three compile-time
# shapes of the standard layers, then the generic instantiation (stride 1,
# c_in % 4 != 0, kh != kw, stride 3, the ODD spec's padded last layer)
LAYER_SHAPES = [
    (4, 4, 2, 12, 16, 1, 86, 86), (3, 3, 2, 16, 16, 8, 43, 43),
    (3, 3, 2, 16, 4, 2, 23, 23), (4, 4, 2, 4, 16, 2, 402, 402),
    (3, 3, 1, 8, 8, 2, 17, 23), (3, 3, 1, 6, 8, 1, 19, 16),
    (2, 3, 1, 5, 4, 2, 9, 14), (3, 3, 3, 4, 8, 1, 25, 31),
    (3, 3, 2, 16, 8, 3, 23, 22),
]


@pytest.mark.parametrize("kh,kw,s,c_in,c_out,B,H,W", LAYER_SHAPES)
def test_layer_kernels_match_plain_with_every_plan(cuda, kh, kw, s, c_in,
                                                   c_out, B, H, W):
    """K3 with the planner's plan and with one plan of each register tile
    (on a ragged 5x7 tile), and K2 on each group view: within 1e-5 of the
    plain version and all bit for bit equal, since every plan sums each
    output in one order."""
    from repro_torch.core.passplan import (PASS_TASK_SHAPES, TASK_SHAPES,
                                           conv_tile_layout)
    gen = torch.Generator().manual_seed(kh * 100 + c_in * 10 + s)
    x = torch.rand((B, H, W, c_in), generator=gen).to(cuda)
    w = (torch.randn((kh, kw, c_in, c_out), generator=gen) * 0.2).to(cuda)
    b = (torch.randn(c_out, generator=gen) * 0.1).to(cuda)
    ho, wo = (H - kh) // s + 1, (W - kw) // s + 1
    want = miniconv_layer_grouped_ref(x, w, b, stride=s)
    got = kmod.miniconv_layer_grouped(x, w, b, stride=s)
    torch.testing.assert_close(got, want, atol=FEAT_TOL, rtol=FEAT_TOL)
    for shape in TASK_SHAPES:
        cob = c_out if c_out % shape[1] == 0 else None
        if cob is None:
            continue
        tp = conv_tile_layout(B, ho, wo, kh, kw, s, c_in, c_out, min(5, ho),
                              min(7, wo), cob, shape)
        other = kmod.launch_layer(x, w, b, stride=s, tp=tp, grouped=True)
        assert torch.equal(other, got), shape
    for g in range(0, c_out, 4):
        part = kmod.miniconv_pass(x, w[..., g:g + 4], b[g:g + 4], stride=s)
        assert torch.equal(part, got[..., g:g + 4])
        for shape in PASS_TASK_SHAPES:
            alt = conv_tile_layout(B, ho, wo, kh, kw, s, c_in, 4,
                                   min(3, ho), min(4, wo), 4, shape)
            assert torch.equal(kmod.launch_layer(
                x, w[..., g:g + 4], b[g:g + 4], stride=s, tp=alt,
                grouped=False), part), shape
    assert torch.equal(got, kmod.miniconv_layer_grouped(x, w, b, stride=s))


def test_layer_kernels_copy_only_what_they_cannot_address(cuda):
    """A transposed weight and a strided input are copied and counted; a
    group view and a misaligned (4-byte offset) input are read in
    place."""
    gen = torch.Generator().manual_seed(11)
    big = torch.rand((1, 20, 20, 13), generator=gen).to(cuda)
    x = big[..., 1:]                       # strided: copied
    w = (torch.randn((4, 3, 3, 12), generator=gen) * 0.2).to(cuda)
    b = torch.zeros(4, device=cuda)
    kmod.miniconv_pass.copies = 0
    got = kmod.miniconv_pass(x, w.permute(1, 2, 3, 0), b, stride=2)
    assert kmod.miniconv_pass.copies == 2
    torch.testing.assert_close(
        got, miniconv_pass_ref(x, w.permute(1, 2, 3, 0), b, stride=2),
        atol=FEAT_TOL, rtol=FEAT_TOL)
    flat = torch.rand(1 + 20 * 20 * 12, generator=gen).to(cuda)
    xm = flat[1:].view(1, 20, 20, 12)      # 4 bytes off 16-byte alignment
    wl = (torch.randn((3, 3, 12, 16), generator=gen) * 0.2).to(cuda)
    kmod.miniconv_pass.copies = 0
    got = kmod.miniconv_pass(xm, wl[..., 8:12], b, stride=2)
    assert kmod.miniconv_pass.copies == 0
    torch.testing.assert_close(
        got, miniconv_pass_ref(xm, wl[..., 8:12], b, stride=2),
        atol=FEAT_TOL, rtol=FEAT_TOL)


def test_served_reference_request_makes_no_copies(cuda):
    """One served frame on the reference tier: 9 K2 launches on the
    layers' group views, no input copied."""
    spec = standard_spec(c_in=12, k=4)
    params = miniconv_init(torch.Generator().manual_seed(6), spec,
                           device=cuda)
    x = torch.rand((1, 84, 84, 12), generator=torch.Generator()
                   .manual_seed(7)).to(cuda)
    kmod.miniconv_pass.launches = kmod.miniconv_pass.copies = 0
    out = miniconv_apply(params, spec, x, use_kernel="reference")
    torch.cuda.synchronize()
    assert kmod.miniconv_pass.launches == 9
    assert kmod.miniconv_pass.copies == 0
    torch.testing.assert_close(
        out, miniconv_apply(params, spec, x, use_kernel="xla"),
        atol=FEAT_TOL, rtol=FEAT_TOL)


def test_tiers_agree_and_count_launches(cuda):
    spec = standard_spec(c_in=12, k=4)
    params = miniconv_init(torch.Generator().manual_seed(1), spec,
                           device=cuda)
    x = torch.rand((2, 84, 84, 12), generator=torch.Generator()
                   .manual_seed(2)).to(cuda)
    kmod.miniconv_encoder.launches = kmod.miniconv_pass.launches = 0
    fused = miniconv_apply(params, spec, x, use_kernel="fused")
    per_pass = miniconv_apply(params, spec, x, use_kernel="reference")
    xla = miniconv_apply(params, spec, x, use_kernel="xla")
    assert kmod.miniconv_encoder.launches == 1
    assert kmod.miniconv_pass.launches == spec.total_passes == 9
    torch.testing.assert_close(fused, per_pass, atol=FEAT_TOL, rtol=FEAT_TOL)
    torch.testing.assert_close(fused, xla, atol=FEAT_TOL, rtol=FEAT_TOL)


@pytest.mark.parametrize("B,H,c_in", [(1, 84, 12), (8, 84, 12),
                                      (2, 400, 4)])
def test_grouped_kernel_matches_plain_on_every_standard_layer(cuda, B, H,
                                                              c_in):
    spec = standard_spec(c_in=c_in, k=4)
    plan, x, ws, bs, _, _ = _case(spec, B, H, H, None, cuda)
    y = x
    for l, w, b in zip(plan.layers, ws, bs):
        xp = same_pad(y, l.kernel, l.stride)
        before = kmod.miniconv_layer_grouped.launches
        got = kmod.miniconv_layer_grouped(xp, w, b, stride=l.stride)
        want = miniconv_layer_grouped_ref(xp, w, b, stride=l.stride)
        torch.cuda.synchronize()
        assert kmod.miniconv_layer_grouped.launches == before + 1
        torch.testing.assert_close(got, want, atol=FEAT_TOL, rtol=FEAT_TOL)
        y = torch.relu(want)


def test_grouped_tier_equals_reference_tier_bitwise(cuda):
    """K3 sums in K2's order, so the two tiers agree bit for bit, a
    c_out % 4 != 0 layer included."""
    params = miniconv_init(torch.Generator().manual_seed(3), ODD,
                           device=cuda)
    x = torch.rand((8, 84, 84, 12), generator=torch.Generator()
                   .manual_seed(4)).to(cuda)
    kmod.miniconv_layer_grouped.launches = kmod.miniconv_pass.launches = 0
    grouped = miniconv_apply(params, ODD, x, use_kernel="grouped")
    reference = miniconv_apply(params, ODD, x, use_kernel="reference")
    assert kmod.miniconv_layer_grouped.launches == 3
    assert kmod.miniconv_pass.launches == ODD.total_passes
    assert torch.equal(grouped, reference)


@pytest.mark.parametrize("spec,B,H,W,D,chunk", [
    (standard_spec(c_in=12, k=4), 8, 84, 84, None, 3),
    (standard_spec(c_in=12, k=4), 13, 84, 84, 512, 4),
    (standard_spec(c_in=4, k=4), 5, 128, 128, 512, 2),
    (ODD, 7, 85, 83, 200, 3),
    (standard_spec(c_in=4, k=4), 33, 400, 400, 512, 2),
    # the benchmark's batches, in the plan's chunks, and one frame more:
    # a last item of one frame, short of a pass of several
    (standard_spec(c_in=12, k=4), 256, 84, 84, None, None),
    (standard_spec(c_in=12, k=4), 257, 84, 84, None, None),
    (standard_spec(c_in=12, k=4), 257, 84, 84, 512, None),
    (standard_spec(c_in=4, k=4), 64, 400, 400, None, None),
    (standard_spec(c_in=4, k=4), 65, 400, 400, None, None),
    (standard_spec(c_in=4, k=4), 65, 400, 400, 512, None),
], ids=["shared", "shared+head", "global+head", "odd+head", "400x400+head",
        "envs256", "envs257", "envs257+head", "cam64", "cam65",
        "cam65+head"])
def test_stream_kernel_equals_fused_kernel(cuda, spec, B, H, W, D, chunk):
    """K4 runs K1's layer body over passes of several frames, so it equals
    K1 bit for bit at every batch, a ragged last item and a ragged last
    round included, in one launch (``chunk`` None: the plan's
    ``max_safe_batch``, as the benchmark streams)."""
    plan, x, ws, bs, hw, hb = _case(spec, B, H, W, D, cuda)
    chunk = chunk or plan.max_safe_batch()
    kmod.miniconv_encoder.launches = kmod.miniconv_encoder_stream.launches = 0
    got = kmod.miniconv_encoder_stream(x, ws, bs, plan, chunk_b=chunk,
                                       head_w=hw, head_b=hb)
    whole = kmod.miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb)
    want = miniconv_encoder_ref(x, ws, bs, plan, head_w=hw, head_b=hb)
    torch.cuda.synchronize()
    assert kmod.miniconv_encoder_stream.launches == 1
    assert kmod.miniconv_encoder.launches == 1
    if D is None:
        got, whole, want = (got, None), (whole, None), (want, None)
    assert torch.equal(got[0], whole[0])
    assert D is None or torch.equal(got[1], whole[1])
    torch.testing.assert_close(got[0], want[0], atol=FEAT_TOL, rtol=FEAT_TOL)
    if D is not None:
        torch.testing.assert_close(got[1], want[1], atol=Z_TOL, rtol=Z_TOL)
    # a batch within one chunk falls through to K1
    kmod.miniconv_encoder.launches = kmod.miniconv_encoder_stream.launches = 0
    kmod.miniconv_encoder_stream(x[:chunk], ws, bs, plan, chunk_b=chunk)
    assert kmod.miniconv_encoder_stream.launches == 0
    assert kmod.miniconv_encoder.launches == 1


@pytest.mark.parametrize("c_in,side,B", [(12, 84, 9), (4, 400, 5)],
                         ids=["84x84x12", "400x400x4"])
def test_every_stream_layout_equals_fused_kernel(cuda, c_in, side, B):
    """Each K4 layout the planner may choose (tile size, frames a pass),
    launched with ``launch_encoder``, computes K1's
    features bit for bit: a frame's sum does not depend on the tile or on
    the frames beside it in a pass.  The batches leave a ragged last
    item."""
    from repro_torch.core.passplan import tile_candidates
    plan, x, ws, bs, _, _ = _case(standard_spec(c_in=c_in, k=4), B, side,
                                  side, None, cuda)
    want = kmod.miniconv_encoder(x, ws, bs, plan)
    seen = set()
    for tp in tile_candidates(plan):
        got = kmod.launch_encoder(x, ws, bs, plan, tp, chunk_b=B)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tp.tile_h, tp.frames)
        seen.add(tp.frames)
    assert {1, 2} <= seen


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")
    for name in ("miniconv_encoder_ref", "miniconv_pass_ref",
                 "miniconv_layer_grouped_ref", "miniconv_encoder_stream_ref"):
        monkeypatch.setattr(kmod, name, refuse)
    spec = standard_spec(c_in=12, k=4)
    plan, x, ws, bs, hw, hb = _case(spec, 3, 84, 84, 512, cuda)
    kmod.miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb)
    kmod.miniconv_encoder_stream(x, ws, bs, plan, chunk_b=2, head_w=hw,
                                 head_b=hb)
    params = {f"layer{i}": {"kernel": w, "bias": b}
              for i, (w, b) in enumerate(zip(ws, bs))}
    for mode in ("reference", "grouped"):
        miniconv_apply(params, spec, x, use_kernel=mode)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="one device"):
        kmod.miniconv_encoder(x.cpu(), ws, bs, plan)


@pytest.mark.parametrize("B,kernel", [(256, "encoder_stream_kernel"),
                                      (8, "encoder_kernel")],
                         ids=["K4", "K1"])
def test_split_spans_on_card(cuda, B, kernel):
    """The split path's full span tree on the card, where the K1/K4
    wrapper adds ``encoder.prepare`` and ``encoder.launch``; under the
    profiler the encoder kernel's launch lies inside ``encoder.launch``
    on the profiler's clock.  256 frames at 84x84 stream through K4
    (past ``max_safe_batch``); 8 fall through to K1."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.deploy import Deployment, DeploymentConfig
    cfg = DeploymentConfig.standard(k=4, c_in=12, h=84, backend="fused",
                                    head_dim=512, max_batch=256)
    dep = Deployment.build(cfg, device=cuda)
    assert dep.max_safe_batch < 256 and dep.stream_chunk is not None
    params = dep.init(torch.Generator().manual_seed(0))
    obs = torch.rand((B, 84, 84, 12),
                     generator=torch.Generator().manual_seed(1)).to(cuda)

    def tick():
        with torch.inference_mode():
            payload = dep.split.edge_step_batch(params["edge"], obs)
            return dep.split.server_step_batch(params["server"], payload)

    want = tick()
    torch.cuda.synchronize()
    tracing.records()
    tracing.enable()
    try:
        tracing.request(3)
        got = tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tick()
            torch.cuda.synchronize()
    finally:
        tracing.disable()
    assert torch.equal(got, want)
    recs = tracing.records()
    tree = ["split.edge", "encoder", "encoder.check", "encoder.prepare",
            "encoder.launch", "codec.encode", "split.server",
            "codec.decode", "server.apply"]
    assert [r[0] for r in recs] == tree * 2
    parents = [None, 0, 1, 1, 1, 0, None, 6, 6]
    assert [r[3] for r in recs[:9]] == parents
    assert [r[3] - 9 if r[3] is not None else None
            for r in recs[9:]] == parents
    assert all(r[4] == 3 for r in recs)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert set(spans) == set(tree)
    launch = spans["encoder.launch"]
    corr = [e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and f"::{kernel}(" in e["name"]]
    assert len(corr) == 1
    host = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
            and (e.get("args") or {}).get("correlation") == corr[0]]
    assert len(host) == 1
    assert launch["ts"] <= host[0]["ts"] <= launch["ts"] + launch["dur"]


@pytest.mark.parametrize("S", [100, 128, 512])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "non-causal"])
def test_flash_kernel_matches_plain(cuda, S, D, window, dtype, causal):
    """Causal, and non-causal as Whisper's encoder calls it (every KV tile
    of a block's rows, the ragged last one masked at S = 100)."""
    gen = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn((2, 3, S, D), generator=gen).to(cuda, dtype)
               for _ in range(3))
    before = fmod.flash_attention.launches
    got = fmod.flash_attention(q, k, v, causal=causal, sliding_window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         sliding_window=window)
    torch.cuda.synchronize()
    assert fmod.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    again = fmod.flash_attention(q, k, v, causal=causal,
                                 sliding_window=window)
    assert torch.equal(got, again)                  # repeats bit for bit


def _counts():
    f = fmod.flash_attention
    return f.launches, f.tc_launches, f.copies


def _gqa_views(B, H, H_kv, S, D, dtype, dev, seed):
    """q (B, H, S, D) and k, v (B, H_kv, S, D) as transposed views of
    (B, S, heads, D) tensors, as the decoder's projections give them."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, S, H, D), generator=gen).to(dev, dtype)
    k, v = (torch.randn((B, S, H_kv, D), generator=gen).to(dev, dtype)
            for _ in range(2))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _plain_gqa(q, k, v, window, causal=True):
    n_rep = q.shape[1] // k.shape[1]
    return attention_ref(q.float(), k.float().repeat_interleave(n_rep, 1),
                         v.float().repeat_interleave(n_rep, 1),
                         causal=causal, sliding_window=window)


# (n_rep, D, window, dtype, causal): every causal combination, and one
# non-causal case, Whisper's encoder's head dim on the tensor cores
GQA_CASES = [pytest.param(n_rep, D, window, dtype, True,
                          id=f"{name}-{window}-{D}-{n_rep}")
             for dtype, name in ((torch.float32, "f32"),
                                 (torch.bfloat16, "bf16"))
             for window in (None, 48) for D in (32, 64, 128)
             for n_rep in (1, 2, 8)]
GQA_CASES.append(pytest.param(2, 64, None, torch.bfloat16, False,
                              id="bf16-None-64-2-non-causal"))
# qwen2.5-14b's and llama4-scout's group: 40 query heads over 8 KV heads
GQA_CASES += [pytest.param(5, 128, window, dtype, True,
                           id=f"{name}-{window}-128-5")
              for dtype, name in ((torch.float32, "f32"),
                                  (torch.bfloat16, "bf16"))
              for window in (None, 48)]


@pytest.mark.parametrize("n_rep,D,window,dtype,causal", GQA_CASES)
def test_flash_kernel_gqa_strided_views(cuda, n_rep, D, window, dtype,
                                        causal):
    """K5 maps query heads to KV heads and reads (B, S, H, D) storage in
    place: held to its plain version on repeated K/V, no input copied, the
    bf16 cases on the tensor-core route, the output (B, S, H, D)
    storage; ragged S."""
    q, k, v = _gqa_views(2, 2 * n_rep, 2, 100, D, dtype, cuda, D + n_rep)
    before = _counts()
    got = fmod.flash_attention(q, k, v, causal=causal, sliding_window=window)
    want = _plain_gqa(q, k, v, window, causal)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16)
    assert _counts() == (before[0] + 1, before[1] + tc, before[2])
    assert got.dtype == dtype and got.shape == q.shape
    assert got.transpose(1, 2).is_contiguous()
    tol = 2e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
    again = fmod.flash_attention(q, k, v, causal=causal,
                                 sliding_window=window)
    assert torch.equal(got, again)                  # repeats bit for bit


@pytest.mark.parametrize("S,D,H,H_kv,window", [
    (1100, 128, 16, 8, None), (700, 64, 32, 4, 200), (300, 96, 8, 8, None),
    (200, 24, 4, 2, 64), (160, 256, 4, 2, None)],
    ids=["two-warpgroups", "two-warpgroups-d64", "d96", "d24",
         "d256-cuda-cores"])
def test_flash_kernel_bf16_routes(cuda, S, D, H, H_kv, window):
    """bf16 at the shapes that pick each variant: 128-row blocks of two
    consumer warpgroups (enough blocks to fill the SMs), D padded to 128
    or 64 with zeros (96, 24), and D = 256 on the CUDA cores; every S
    ragged against the kernel's tiles (one block of the reference's
    contract, so any S passes it)."""
    q, k, v = _gqa_views(1, H, H_kv, S, D, torch.bfloat16, cuda, S + D)
    before = _counts()

    def run():
        return fmod.flash_attention(q, k, v, causal=True,
                                    sliding_window=window, block_q=S,
                                    block_k=S)
    got = run()
    want = _plain_gqa(q, k, v, window)
    torch.cuda.synchronize()
    tc = int(D <= 128)
    assert fmod.tensor_core_route(torch.bfloat16, D) == bool(tc)
    assert _counts() == (before[0] + 1, before[1] + tc, before[2])
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    assert torch.equal(got, run())


def test_flash_kernel_long_context_prefill_window(cuda):
    """long_500k's prefill core: Qwen3-0.6B's (1,16/8,8192,128) bf16
    views with every attention block windowed at 4,096 (the config's
    ``long_context_window``), on the tensor-core route, against the plain
    version in f32.  The rows whose window is full average 4,096 values,
    far below 1e-2 in size, so they are also held together relative to
    their size, at 2^-6 (chip_smoke's ``K5_WINDOW_RTOL``): the plain
    version at a window 128 keys shorter, a dropped tile, misses it by
    over 5x."""
    S, W = 8192, 4096
    q, k, v = _gqa_views(1, 16, 8, S, 128, torch.bfloat16, cuda, 81)
    before = _counts()
    got = fmod.flash_attention(q, k, v, causal=True, sliding_window=W)
    want = _plain_gqa(q, k, v, W)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)

    def rel(a):
        d = a[:, :, W:].float() - want[:, :, W:]
        return float(d.norm() / want[:, :, W:].norm())
    assert rel(got) <= 2.0 ** -6 < rel(_plain_gqa(q, k, v, W - 128)) / 5


def test_flash_kernel_copies_only_what_it_cannot_address(cuda):
    """A misaligned base and a strided last dim are copied and counted;
    the results still match."""
    gen = torch.Generator().manual_seed(9)
    big = torch.randn((1, 4, 128, 72), generator=gen).to(cuda,
                                                         torch.bfloat16)
    q = big[..., 4:68]                      # base 8 bytes off alignment
    k = big[..., :64].clone()
    v = torch.randn((1, 4, 64, 128), generator=gen).to(
        cuda, torch.bfloat16).transpose(2, 3)   # last-dim stride 128
    before = _counts()
    got = fmod.flash_attention(q, k, v)
    want = _plain_gqa(q, k, v, None)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype,tc", [(torch.float32, 0),
                                      (torch.bfloat16, 1)],
                         ids=["f32-cuda-cores", "bf16-tensor-cores"])
def test_attention_on_cuda_launches_k5_once(cuda, monkeypatch, dtype, tc):
    """A GQA layer's core is one K5 launch that copies nothing: on the
    tensor-core route in bf16, on the CUDA cores in f32."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(fmod, "attention_ref", refuse)
    cfg = t_attn.AttentionConfig(d_model=256, n_heads=4, n_kv_heads=2,
                                 head_dim=64, qk_norm=True)
    gen = torch.Generator().manual_seed(5)
    params = t_attn.attention_init(gen, cfg, dtype=dtype, device=cuda)
    x = torch.randn((2, 128, 256), generator=gen).to(cuda, dtype)
    f = fmod.flash_attention
    f.launches = f.tc_launches = f.copies = 0
    out = t_attn.attention(params, cfg, x)
    torch.cuda.synchronize()
    assert _counts() == (1, tc, 0)
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


def test_real_fleet_on_cuda_serves_bitwise(cuda):
    """A 2-worker fleet of config A's ``fused`` build on the card: each
    spawned worker serves on its own CUDA context with the parent's TF32
    switches, and the actions equal in-process serving bit for bit through
    every router and after a worker is killed, with no leaked worker."""
    from repro_torch import deploy as t_deploy
    cfg = t_deploy.DeploymentConfig.standard(
        k=4, c_in=12, h=84, backend="fused", max_batch=4, n_servers=2,
        router="least_loaded")
    seen = t_deploy._real_fleet_check(cfg, n_requests=4, device="cuda")
    assert seen["bitwise"] and seen["leaked"] == []
    assert seen["device"] == "cuda" and min(seen["per_server"]) > 0
    assert seen["per_server_after_kill"][1] >= 4


# ------------------------------------------------------------- training
@pytest.mark.parametrize("B,D", [(1, None), (8, 512)],
                         ids=["served", "batch+head"])
def test_encoder_kernel_at_the_training_channels(cuda, B, D):
    """K1 at ``c_in = 9`` (three stacked RGB frames), the shapes a trained
    policy is served at: one frame, and eight with the projection."""
    spec = standard_spec(c_in=9, k=4)
    plan, x, ws, bs, hw, hb = _case(spec, B, 84, 84, D, cuda, seed=3)
    before = kmod.miniconv_encoder.launches
    got = kmod.miniconv_encoder(x, ws, bs, plan, head_w=hw, head_b=hb)
    want = miniconv_encoder_ref(x, ws, bs, plan, head_w=hw, head_b=hb)
    torch.cuda.synchronize()
    assert kmod.miniconv_encoder.launches == before + 1
    if D is None:
        got, want = (got, None), (want, None)
    torch.testing.assert_close(got[0], want[0], atol=FEAT_TOL, rtol=FEAT_TOL)
    if D is not None:
        torch.testing.assert_close(got[1], want[1], atol=Z_TOL, rtol=Z_TOL)


@pytest.mark.parametrize("algo", ["ddpg", "sac", "ppo"])
def test_update_on_card_matches_cpu(cuda, algo):
    """One update of each algorithm from the same TrainState, batch and
    draws on the card and on the CPU: gradients (the first Adam moment
    from zero) within 1e-4 of each leaf's largest element, parameters
    within 2 * lr (Adam's first step is about lr * sign(g)), losses within
    1e-4."""
    import numpy as np

    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.rl.agent import make_agent, move_state
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.ppo import PPOConfig
    from repro_torch.rl.sac import SACConfig
    from repro_torch.rl.train import _pipeline_encoder

    A = {"ddpg": 1, "sac": 3, "ppo": 6}[algo]
    cfg = {"ddpg": DDPGConfig(batch_size=16), "sac": SACConfig(batch_size=16),
           "ppo": PPOConfig(n_envs=2, n_steps=8, n_epochs=1,
                            n_minibatches=1)}[algo]
    agents = {d: make_agent(algo, _pipeline_encoder("miniconv4", 9,
                                                    device=d), A, cfg=cfg,
                            device=d) for d in ("cpu", "cuda")}
    state = agents["cpu"].init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    if algo == "ppo":
        T, N = 8, 2
        data = {"traj": {
            "obs": rng.random((T, N, 84, 84, 9)).astype(np.float32),
            "action": rng.standard_normal((T, N, A)).astype(np.float32),
            "reward": rng.standard_normal((T, N)).astype(np.float32),
            "done": rng.random((T, N)) < 0.2,
            "logp": (rng.standard_normal((T, N)) - 5).astype(np.float32),
            "value": rng.standard_normal((T, N)).astype(np.float32)},
            "last_obs": rng.random((N, 84, 84, 9)).astype(np.float32)}
    else:
        B = 16
        data = {"obs": rng.random((B, 84, 84, 9)).astype(np.float32),
                "next_obs": rng.random((B, 84, 84, 9)).astype(np.float32),
                "actions": rng.uniform(-1, 1, (B, A)).astype(np.float32),
                "rewards": rng.standard_normal(B).astype(np.float32),
                "dones": (rng.random(B) < 0.3).astype(np.float32)}
    data = tree_map(lambda a: torch.from_numpy(np.asarray(a)), data)
    noise = agents["cpu"].draw_noise(torch.Generator().manual_seed(2), data)
    out = {}
    for d in ("cpu", "cuda"):
        move = (lambda t: t.to(d))  # noqa: E731
        n = None if noise is None else (
            noise.to(d) if isinstance(noise, torch.Tensor)
            else tuple(move(x) for x in noise))
        out[d] = agents[d].update(move_state(state, d), tree_map(move, data),
                                  noise=n)
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    for k in cm:
        torch.testing.assert_close(gm[k].cpu(), cm[k], rtol=1e-4, atol=1e-5)
    for want, got in zip(tree_leaves(cs.opt_state.mu),
                         tree_leaves(gs.opt_state.mu)):
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    for want, got in zip(tree_leaves(cs.params), tree_leaves(gs.params)):
        assert float((got.cpu() - want).abs().max()) <= 2 * cfg.lr


# ------------------------------------------------------------ populations
@pytest.mark.parametrize("algo", ["ddpg", "sac", "ppo"])
def test_batched_lanes_on_card_have_no_vmap_fallbacks(cuda, algo):
    """The population's batched act and update at 84x84x9 on the card:
    every op has a batching rule (no per-member fallback loop), every
    loss is finite, and an ``lr = 0`` member keeps its parameters."""
    import numpy as np

    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.rl import population as pop
    from repro_torch.rl.ddpg import DDPGConfig
    from repro_torch.rl.ppo import PPOConfig
    from repro_torch.rl.sac import SACConfig
    from repro_torch.rl.train import _pipeline_encoder

    A = {"ddpg": 1, "sac": 3, "ppo": 6}[algo]
    cfg = {"ddpg": DDPGConfig(batch_size=16), "sac": SACConfig(batch_size=16),
           "ppo": PPOConfig(n_envs=2, n_steps=8, n_epochs=1,
                            n_minibatches=2)}[algo]
    lanes = pop.BatchedLanes(algo, _pipeline_encoder("miniconv4", 9,
                                                     device=cuda),
                             A, cfg, {"lr": [3e-4, 1e-3, 0.0]}, device=cuda)
    state = pop.stack_trees([lanes.agent.init(
        torch.Generator().manual_seed(p)) for p in range(3)])
    rng = np.random.default_rng(1)
    if algo == "ppo":
        T, N = 8, 2
        data = {"traj": {
            "obs": rng.random((3, T, N, 84, 84, 9)),
            "action": rng.standard_normal((3, T, N, A)),
            "reward": rng.standard_normal((3, T, N)),
            "done": rng.random((3, T, N)) < 0.2,
            "logp": rng.standard_normal((3, T, N)) - 5,
            "value": rng.standard_normal((3, T, N))},
            "last_obs": rng.random((3, N, 84, 84, 9))}
        obs = data["traj"]["obs"][:, 0]
    else:
        data = {"obs": rng.random((3, 16, 84, 84, 9)),
                "next_obs": rng.random((3, 16, 84, 84, 9)),
                "actions": rng.uniform(-1, 1, (3, 16, A)),
                "rewards": rng.standard_normal((3, 16)),
                "dones": (rng.random((3, 16)) < 0.3).astype(np.float32)}
        obs = data["obs"][:, :2]
    def to(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                                else a).to(cuda)

    data, obs = tree_map(to, data), to(obs)
    gens = [torch.Generator(device=cuda).manual_seed(p) for p in range(3)]
    with pop.vmap_fallbacks() as found:
        action, _ = lanes.act(state.params, obs,
                              lanes.act_noise(gens, obs.shape[1]))
        new, metrics = lanes.update(state, data,
                                    lanes.update_noise(gens, data))
        torch.cuda.synchronize()
    assert found == []
    assert action.shape == (3, obs.shape[1], A)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    for a, b in zip(tree_leaves(state.params), tree_leaves(new.params)):
        assert torch.equal(a[2], b[2])


def test_exact_member0_bitwise_on_card_in_deterministic_mode(cuda):
    """Member 0 of a P=2 population (exact lanes, with updates) against
    ``train()`` at its seed on the card, in a process started with
    cuBLAS's deterministic workspace and
    ``torch.use_deterministic_algorithms(True)``."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import json, torch\n"
            "torch.use_deterministic_algorithms(True)\n"
            "from repro_torch.benchmarks.population import "
            "check_member0_parity\n"
            "print(json.dumps(check_member0_parity(device='cuda')))\n")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["bitwise"], row


# ---------------------------------------------------------------------------
# The LM decode path and training on the card (reduced qwen3-0.6b, f32)
# ---------------------------------------------------------------------------

def test_flash_kernel_refuses_inputs_that_require_grad(cuda):
    """K5 has no backward pass: a CUDA input that requires grad is refused
    before anything launches; under no_grad the same inputs run."""
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((1, 4, 128, 64), generator=gen).to(cuda)
               for _ in range(3))
    q.requires_grad_()
    before = fmod.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fmod.flash_attention(q, k, v)
    assert fmod.flash_attention.launches == before
    with torch.no_grad():
        fmod.flash_attention(q, k, v)
    assert fmod.flash_attention.launches == before + 1


def test_flash_kernel_launches_on_cuda_and_records_its_work(cuda):
    """A CUDA call launches K5 and counts one launch, as it did before the
    ``meta`` branch came: that branch is taken for ``meta`` tensors only.
    Both record the kernel's FLOPs and bytes into the cost counter."""
    from repro_torch.costs import CostCounter, attention_flops
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn((1, n, 256, 128), generator=gen)
               .to(cuda, torch.bfloat16) for n in (16, 8, 8))
    before = fmod.flash_attention.launches
    with torch.no_grad(), CostCounter("cuda") as c:
        out = fmod.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fmod.flash_attention.launches == before + 1
    assert out.is_cuda and torch.isfinite(out.float()).all()
    qm, km, vm = q.to("meta"), k.to("meta"), v.to("meta")
    with CostCounter("meta") as m:
        fmod.flash_attention(qm, km, vm, causal=True)
    assert fmod.flash_attention.launches == before + 1
    flops = attention_flops(1, 16, 256, 256, 128, causal=True)
    assert c.flops == m.flops == flops
    assert c.bytes_accessed == m.bytes_accessed == \
        (2 * q.numel() + k.numel() + v.numel()) * 2


def test_lm_decode_and_train_step_on_card(cuda):
    """Decode over an f32 cache against the card's forward (1e-4) and the
    CPU's decode (1e-4) with no K5 launch; one Trainer step against the
    CPU's (gradients 1e-4 of each leaf's largest, parameters 2 lr, loss
    1e-4), also with no K5 launch, and non-zero q/k/v gradients."""
    from repro_torch.data import lm_batches
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg, model = get_model("qwen3-0.6b", reduced=True)
    p_cpu = model.init(torch.Generator().manual_seed(3), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    tok = torch.randint(3, cfg.vocab, (1, 32),
                        generator=torch.Generator().manual_seed(4))

    def decode(p, device):
        c = model.init_cache(1, 32, torch.float32, device=device)
        i = torch.zeros((), dtype=torch.int64, device=device)
        out = []
        for t in range(32):
            lg, c = model.decode_step(p, tok[:, t:t + 1].to(device), c, i)
            i += 1
            out.append(lg)
        return torch.cat(out, 1)

    with torch.no_grad():
        full, _ = model.forward(p_gpu, tok.to(cuda))
    before = fmod.flash_attention.launches
    dec = decode(p_gpu, cuda)
    assert fmod.flash_attention.launches == before
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dec.cpu(), decode(p_cpu, "cpu"), atol=1e-4,
                               rtol=1e-4)

    lr = 1e-3
    batch = next(lm_batches(cfg.vocab, 2, 32, seed=5, device="cpu"))

    def step(p, device):
        b = {k: v.to(device) for k, v in batch.items()}
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = model.loss(tree_unflatten(p, leaves), b)
        grads = torch.autograd.grad(loss, leaves)
        tr = Trainer(cfg, TrainConfig(batch=2, steps=10, lr=lr, warmup=1),
                     device=device)
        new, _, m = tr.step(p, tr.optimizer.init(p), b)
        return grads, new, float(m["loss"])

    before = fmod.flash_attention.launches
    g_gpu, new_gpu, l_gpu = step(p_gpu, cuda)
    assert fmod.flash_attention.launches == before
    g_cpu, new_cpu, l_cpu = step(p_cpu, "cpu")
    assert abs(l_gpu - l_cpu) <= 1e-4
    for a, b in zip(g_gpu, g_cpu):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()
    for a, b in zip(tree_leaves(new_gpu), tree_leaves(new_cpu)):
        assert (a.cpu() - b).abs().max() <= 2 * lr
    named = dict(zip([n for n, _ in tree_paths(p_cpu)], g_gpu))
    for n in ("wq", "wk", "wv"):
        g = named[f"scan/b0_attn/attn/{n}/kernel"]
        assert (g.abs().flatten(1).amax(1) > 0).all()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_lm_families_on_card(cuda, arch, monkeypatch):
    """Each family's reduced f32 config, card against CPU: forward logits
    and 16 decode steps within 1e-5 of their largest, the MoE's expert
    indices equal and its auxiliary loss within 1e-6, and a step's
    gradients within 1e-5 of each leaf's largest, all finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.nn.module import tree_leaves, tree_map, tree_unflatten
    cfg = get_config(arch).reduced()
    model = DecoderModel(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(6), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    tok = torch.randint(3, cfg.vocab, (2, 32),
                        generator=torch.Generator().manual_seed(7))

    def forward(p, device):
        routing, inner = [], blocks.moe_apply

        def recording(*args, **kwargs):
            y, aux = inner(*args, **kwargs)
            routing.append(aux["expert_idx"].cpu())
            return y, aux

        with monkeypatch.context() as m, torch.no_grad():
            m.setattr(blocks, "moe_apply", recording)
            logits, aux = model.forward(p, tok.to(device))
        return logits.cpu(), float(aux["moe_aux_loss"]), routing

    def decode(p, device):
        c = model.init_cache(2, 16, torch.float32, device=device)
        return torch.cat([model.decode_step(p, tok[:, t:t + 1].to(device),
                                            c, t)[0] for t in range(16)],
                         1).cpu()

    def grads(p, device):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = model.loss(tree_unflatten(p, leaves),
                             {"tokens": tok.to(device)})
        return [g.cpu() for g in torch.autograd.grad(loss, leaves)]

    (lg, aux_g, idx_g), (lc, aux_c, idx_c) = forward(p_gpu, cuda), \
        forward(p_cpu, "cpu")
    assert (lg - lc).abs().max() <= 1e-5 * lc.abs().max()
    assert abs(aux_g - aux_c) <= 1e-6
    assert len(idx_g) == len(idx_c) == (2 if cfg.moe else 0)
    assert all(torch.equal(a, b) for a, b in zip(idx_g, idx_c))
    dg, dc = decode(p_gpu, cuda), decode(p_cpu, "cpu")
    assert (dg - dc).abs().max() <= 1e-5 * dc.abs().max()
    for a, b in zip(grads(p_gpu, cuda), grads(p_cpu, "cpu")):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_whisper_on_card(cuda):
    """The reduced f32 whisper-medium, card against CPU: the encoder (two
    non-causal K5 launches), the teacher-forced decoder at a ragged 200
    tokens (two causal launches), and 16 decode steps over the CPU's bf16
    cross cache (no K5 launch), each within 1e-5 of its largest, the
    card's own cross cache within a bf16 step; a step's gradients within
    1e-5 of each leaf's largest, all finite (the key biases', zero in
    exact arithmetic, below 1e-5 of the largest of all leaves)."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.whisper import WhisperModel
    from repro_torch.nn.module import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
    cfg, model = get_model("whisper-medium", reduced=True)
    assert isinstance(model, WhisperModel)
    p_cpu = model.init(torch.Generator().manual_seed(8), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    gen = torch.Generator().manual_seed(9)
    frames = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                         generator=gen) * 0.02
    tok = torch.randint(3, cfg.vocab, (2, 200), generator=gen)

    def close(a, b):
        a, b = a.detach().cpu().float(), b.detach().float()
        return (a - b).abs().max() <= 1e-5 * b.abs().max()

    def run(p, device, cross=None):
        with torch.no_grad():
            enc = model.encode(p, frames.to(device))
            logits, _ = model.decode_full(p, tok.to(device), enc)
        c = model.prefill_cross_cache(
            p, enc, model.init_cache(2, 16, torch.float32, device=device))
        own = {n: t.cpu() for n, t in c["cross"].items()}
        if cross is not None:   # the CPU's bf16 cross cache, bit for bit
            c["cross"] = {n: t.to(device) for n, t in cross.items()}
        steps = torch.cat([model.decode_step(
            p, tok[:, t:t + 1].to(device), c, t)[0] for t in range(16)], 1)
        return enc, logits, own, c["self"]["k"], steps

    enc_c, lg_c, x_c, k_c, st_c = run(p_cpu, "cpu")
    f = fmod.flash_attention
    f.launches = f.tc_launches = f.copies = 0
    enc_g, lg_g, x_g, k_g, st_g = run(p_gpu, cuda, cross=x_c)
    torch.cuda.synchronize()
    assert _counts() == (4, 0, 0)       # f32: the CUDA-core route
    for a, b in ((enc_g, enc_c), (lg_g, lg_c), (st_g, st_c), (k_g, k_c)):
        assert close(a, b)
    # the bf16 cross caches round f32 values 1e-7 apart: one bf16 step
    for n in ("k", "v"):
        torch.testing.assert_close(x_g[n].float(), x_c[n].float(),
                                   atol=1e-5, rtol=2 ** -7)

    batch = {"tokens": tok[:, :32], "frontend_embeds": frames}

    def grads(p, device):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        loss, _ = model.loss(tree_unflatten(p, leaves),
                             {k: v.to(device) for k, v in batch.items()})
        return [g.cpu() for g in torch.autograd.grad(loss, leaves)]

    f.launches = 0
    g_gpu = grads(p_gpu, cuda)
    assert f.launches == 0
    g_cpu = grads(p_cpu, "cpu")
    floor = 1e-5 * max(b.abs().max() for b in g_cpu)
    for name, a, b in zip([n for n, _ in tree_paths(p_cpu)], g_gpu, g_cpu):
        assert torch.isfinite(a).all()
        if name.endswith("wk/bias"):    # zero in exact arithmetic
            assert max(a.abs().max(), b.abs().max()) <= floor, name
        else:
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
