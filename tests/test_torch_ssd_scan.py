"""K8 (``kernels.ssd_scan``), the chunked SSD scan, against its plain
version ``kernels.ref.ssd_chunked``.

The CPU tier holds the wrapper's plain route (bit for bit), its checks
and its ``meta`` route (which runs the CUDA route's checks and returns
empty outputs), and ``nn.ssm.ssm_forward``'s choice of path.  The GPU
tier (marker ``gpu``; the ``cuda`` fixture skips it without a Hopper card
and nvcc) holds K8 against the plain version on the card with TF32 off;
on the machine with the card, from the root of a checkout::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_ssd_scan.py

Tolerances on the card: y and h_final within 1e-5 of the largest
magnitude of the plain version's, as ``test_torch_ssm.py`` holds the port
against the reference: K8 sums in another order, and its cumulative and
segment sums in float64 where the plain version sums in f32.  A bf16 y is
rounded once from f32, so it may also lie one bf16 rounding (2^-8 of its
size) from the plain y.
"""
import pytest

pytest.importorskip("torch")

import torch
import torch.nn.functional as F

from repro_torch.costs import CostCounter
from repro_torch.kernels import cuda_kernels_supported
from repro_torch.kernels import ssd_scan as kmod
from repro_torch.kernels.ref import ssd_chunked
from repro_torch.nn import ssm

torch.set_num_threads(1)

TOL = 1e-5
BF16_ROUNDING = 2.0 ** -8


@pytest.fixture
def cuda():
    if not cuda_kernels_supported():
        pytest.skip("needs a Hopper (sm_90) card and nvcc: the port's CUDA "
                    "kernels build and run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, S, H, P, G, N, *, seed, dtype=torch.float32, device="cpu"):
    """x, dt, A, B, C, D, h0 as ``ssm_forward`` hands them over: x, B and
    C strided views of one (b, S, H P + 2 G N) tensor, as the conv leaves
    them; dt after the softplus; A as ``ssm_init`` draws it."""
    g = torch.Generator().manual_seed(seed)
    xbc = torch.randn(b, S, H * P + 2 * G * N, generator=g).to(dtype)
    x = xbc[..., :H * P].reshape(b, S, H, P)
    B = xbc[..., H * P:H * P + G * N].reshape(b, S, G, N)
    C = xbc[..., H * P + G * N:].reshape(b, S, G, N)
    dt = F.softplus(torch.randn(b, S, H, generator=g) - 1.0)
    A = -torch.linspace(1.0, 16.0, H)
    D = torch.randn(H, generator=g)
    h0 = torch.randn(b, H, P, N, generator=g)
    return [t.to(device) for t in (x, dt, A, B, C, D, h0)]


def _cfg(chunk=256):
    return ssm.SSMConfig(d_model=64, chunk=chunk)


@pytest.mark.parametrize("S,chunk", [(16, 8), (24, 8), (12, 256)])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_route_equals_plain_bitwise(S, chunk, groups, with_h0, dtype):
    x, dt, A, B, C, D, h0 = _inputs(2, S, 4, 8, groups, 16, seed=S + groups,
                                    dtype=dtype)
    h0 = h0 if with_h0 else None
    y, h = kmod.ssd_scan(_cfg(chunk), x, dt, A, B, C, D, h0=h0)
    want_y, want_h = ssd_chunked(_cfg(chunk), x.float(), dt, A, B.float(),
                                 C.float(), D, h0=h0)
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.equal(y, want_y.to(dtype)) and torch.equal(h, want_h)


def _meta_inputs(b, S, H, P, G, N, dtype=torch.float32):
    """``_inputs``'s shapes, strides and types on ``meta``."""
    xbc = torch.empty(b, S, H * P + 2 * G * N, dtype=dtype, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    return (xbc[..., :H * P].reshape(b, S, H, P), torch.empty(b, S, H, **f32),
            torch.empty(H, **f32),
            xbc[..., H * P:H * P + G * N].reshape(b, S, G, N),
            xbc[..., H * P + G * N:].reshape(b, S, G, N),
            torch.empty(H, **f32))


def test_meta_route_returns_shapes_and_records_the_work():
    b, S, H, P, G, N = 4, 2048, 128, 64, 1, 128
    x, dt, A, B, C, D = _meta_inputs(b, S, H, P, G, N, torch.bfloat16)
    with CostCounter() as cc:
        y, h = kmod.ssd_scan(_cfg(), x, dt, A, B, C, D)
    assert y.device.type == "meta" and tuple(y.shape) == (b, S, H, P)
    assert y.dtype == torch.bfloat16
    assert tuple(h.shape) == (b, H, P, N) and h.dtype == torch.float32
    # granite-4.0-h's layer at the benchmark's 4 x 2,048 steps: C B^T and
    # M x on and below the diagonal, 8 chunk states, 7 incoming states
    tri = 256 * 257 // 2
    want = 2 * b * (8 * tri * N + 8 * H * tri * P + 15 * H * 256 * P * N)
    assert kmod.flops(b, S, H, G, P, N, 256) == want == 49_728_716_800
    assert cc.flops == want
    assert cc.bytes_accessed == kmod.min_bytes(b, S, H, G, P, N)


@pytest.mark.parametrize("bad", ["x_f16", "mixed", "dt_bf16", "head",
                                 "state", "odd_head", "chunk", "long_chunk",
                                 "groups", "shape"])
def test_cuda_checks_refuse_what_k8_does_not_take(bad):
    """The checks a CUDA call runs before it launches, reached here
    through the ``meta`` route, which runs the same checks."""
    b, S, H, P, G, N = 2, 64, 4, 64, 1, 128
    if bad == "head":
        P = 80
    if bad == "state":
        N = 256
    if bad == "odd_head":
        P = 60
    if bad == "groups":
        G, H = 3, 4
    x, dt, A, B, C, D = _meta_inputs(b, S, H, P, G, N)
    cfg = _cfg()
    if bad == "x_f16":
        x, B, C = (t.to(torch.float16) for t in (x, B, C))
    if bad == "mixed":
        x = x.to(torch.bfloat16)
    if bad == "dt_bf16":
        dt = dt.to(torch.bfloat16)
    if bad == "chunk":
        cfg = _cfg(chunk=48)
    if bad == "long_chunk":
        x, dt, A, B, C, D = _meta_inputs(b, 512, H, P, G, N)
        cfg = _cfg(chunk=512)
    if bad == "shape":
        dt = dt[:, :-1]
    err = TypeError if bad in ("x_f16", "mixed", "dt_bf16") else ValueError
    with pytest.raises(err):
        kmod.ssd_scan(cfg, x, dt, A, B, C, D)


def _mixer(dtype=torch.float32, S=16):
    cfg = ssm.SSMConfig(d_model=32, d_state=16, head_dim=8, chunk=8)
    params = ssm.ssm_init(torch.Generator().manual_seed(5), cfg, dtype=dtype,
                          device="cpu")
    u = torch.randn(2, S, 32, generator=torch.Generator().manual_seed(6))
    return cfg, params, u.to(dtype)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference",
                                  "input_grad"])
def test_ssm_forward_takes_the_kernel_unless_autograd_needs_the_inputs(
        mode, monkeypatch):
    cfg, params, u = _mixer()
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(ssm, name, wrapped)

    spy("ssd_scan", ssm.ssd_scan)
    spy("ssd_chunked", ssm.ssd_chunked)
    want = ssm.ssm_forward(params, cfg, u)
    calls.clear()
    if mode == "grad":
        for leaf in (params["A_log"], params["D"]):
            leaf.requires_grad_()
        out = ssm.ssm_forward(params, cfg, u)
    elif mode == "input_grad":
        out = ssm.ssm_forward(params, cfg, u.clone().requires_grad_())
    elif mode == "no_grad":
        with torch.no_grad():
            out = ssm.ssm_forward(params, cfg, u)
    else:
        with torch.inference_mode():
            out = ssm.ssm_forward(params, cfg, u)
    assert calls == (["ssd_chunked"] if mode in ("grad", "input_grad")
                     else ["ssd_scan"])
    assert torch.equal(out.detach(), want.detach())


def test_ssm_forward_in_bf16_rounds_y_as_before():
    """A bf16 mixer: the kernel's route rounds y once to bf16, as the
    plain route's ``y.to(u.dtype)`` does, so both give the same output
    on the CPU."""
    cfg, params, u = _mixer(torch.bfloat16, S=24)
    with torch.no_grad():
        got, h = ssm.ssm_forward(params, cfg, u, return_state=True)
    u2 = u.clone().requires_grad_()
    want, h_want = ssm.ssm_forward(params, cfg, u2, return_state=True)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.detach()) and torch.equal(h, h_want.detach())


# -- on the card --------------------------------------------------------


def _held(got, want, *, rounding=0.0):
    """|got - want| <= TOL * max|want| + rounding * |want|, elementwise."""
    want = want.float()
    limit = TOL * want.abs().max() + rounding * want.abs()
    err = (got.float() - want).abs()
    assert bool((err <= limit).all()), (err.max().item(),
                                        want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("S,chunk,H,P,N", [
    (64, 256, 4, 64, 128), (100, 256, 4, 64, 128), (256, 256, 4, 64, 128),
    (512, 256, 4, 64, 128), (32, 8, 4, 16, 32)],
    ids=["S64", "S100", "S256", "S512", "reduced"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k8_matches_plain_on_card(cuda, S, chunk, H, P, N, groups, with_h0,
                                  dtype):
    x, dt, A, B, C, D, h0 = _inputs(2, S, H, P, groups, N, seed=S + H,
                                    dtype=dtype, device=cuda)
    h0 = h0 if with_h0 else None
    before = kmod.ssd_scan.launches
    with torch.inference_mode():
        y, h = kmod.ssd_scan(_cfg(chunk), x, dt, A, B, C, D, h0=h0)
        want_y, want_h = ssd_chunked(_cfg(chunk), x.float(), dt, A,
                                     B.float(), C.float(), D, h0=h0)
    torch.cuda.synchronize()
    assert kmod.ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    _held(y, want_y,
          rounding=BF16_ROUNDING if dtype == torch.bfloat16 else 0.0)
    _held(h, want_h)


@pytest.mark.gpu
def test_k8_refuses_on_card(cuda):
    x, dt, A, B, C, D, _ = _inputs(2, 64, 4, 64, 1, 128, seed=3, device=cuda)
    with pytest.raises(TypeError):
        kmod.ssd_scan(_cfg(), x.half(), dt, A, B.half(), C.half(), D)
    with pytest.raises(ValueError):
        kmod.ssd_scan(_cfg(chunk=48), x, dt, A, B, C, D)
    with pytest.raises(RuntimeError):
        kmod.ssd_scan(_cfg(), x.requires_grad_(), dt, A, B, C, D)


@pytest.mark.gpu
def test_k8_copies_views_it_cannot_read_in_place(cuda):
    """x, B and C views at an odd offset and stride: K8 reads 16 bytes at
    a time, so the wrapper makes one aligned copy of each."""
    b, S, H, P, G, N = 2, 64, 4, 64, 1, 128
    g = torch.Generator().manual_seed(9)
    xbc = torch.randn(b, S, 1 + H * P + 2 * G * N, generator=g).to(cuda)
    x = xbc[..., 1:1 + H * P].reshape(b, S, H, P)
    B = xbc[..., 1 + H * P:1 + H * P + G * N].reshape(b, S, G, N)
    C = xbc[..., 1 + H * P + G * N:].reshape(b, S, G, N)
    _, dt, A, _, _, D, _ = _inputs(b, S, H, P, G, N, seed=9, device=cuda)
    with torch.inference_mode():
        y, h = kmod.ssd_scan(_cfg(), x, dt, A, B, C, D)
        want_y, want_h = ssd_chunked(_cfg(), x, dt, A, B, C, D)
    _held(y, want_y)
    _held(h, want_h)
