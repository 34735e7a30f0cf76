"""K9 (``kernels.moe_combine``), the dropless MoE's combine, against its
plain version ``kernels.ref.moe_combine_ref`` and against the chain it
replaced in ``nn.moe._moe_dropless``: a zeroed float32 buffer, an
``index_add_`` of the sorted rows by token, the shared expert's output
added as float32, one cast.

The CPU tier holds the plain version equal to that chain bit for bit on
rows whose sums are exact in float32 (multiples of 1/64 under 8, so no
order of addition rounds), over uneven, one-expert, K = 1, T = 1 and
no-shared routings; the wrapper's checks, reached through its ``meta``
route, which runs the CUDA route's checks; and the dropless layer's use
of it.  The GPU tier (marker ``gpu``; the ``cuda`` fixture skips it
without a Hopper card and nvcc) holds K9 on the card; from the root of a
checkout there::

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_moe_combine.py

Tolerances on the card: K9 against the plain float32 sum S, element by
element, |K9 - S| <= 2^-8 |S| + 1e-6 max|S|.  K9 rounds S once to bf16 (at
most half a bf16 step, 2^-8 of |S|), and sums its K + 1 terms in another
order than the plain version (float32 reordering, under 1e-6 of the
largest sum at K = 10).  The whole dropless layer against the parent's
chain: the two differ only in the order of the same float32 additions
before one rounding to bf16, so each element lies within one bf16 step
(2^-7 of its size) of the other's, plus the same 1e-6 of the largest.
"""
import pytest

pytest.importorskip("torch")

import torch

from repro_torch.costs import CostCounter
from repro_torch.kernels import cuda_kernels_supported
from repro_torch.kernels import moe_combine as kmod
from repro_torch.kernels.ref import moe_combine_ref
from repro_torch.nn import moe

torch.set_num_threads(1)

BF16_HALF_STEP = 2.0 ** -8
BF16_STEP = 2.0 ** -7
REORDER = 1e-6


@pytest.fixture
def cuda():
    if not cuda_kernels_supported():
        pytest.skip("needs a Hopper (sm_90) card and nvcc: the port's CUDA "
                    "kernels build and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted(expert_idx):
    """The dropless route's sort of (T, K) expert ids: (order, token, pos),
    pos (T, K) int32 the sorted row of pair (t, k)."""
    T, K = expert_idx.shape
    _, order = torch.sort(expert_idx.reshape(-1), stable=True)
    pos = torch.empty_like(order, dtype=torch.int32).scatter_(
        0, order, torch.arange(T * K, dtype=torch.int32,
                               device=order.device))
    return order, order // K, pos.view(T, K)


def _routing(kind, seed):
    """(expert ids (T, K), D, shared?) for a named routing over 8 experts
    (20 for K = 16): distinct experts a token, as a top-k gives them."""
    g = torch.Generator().manual_seed(seed)
    T, K, E, D, shared = {"uneven": (37, 4, 8, 24, True),
                          "one_expert": (20, 1, 8, 16, True),
                          "first_on_one": (20, 3, 8, 16, True),
                          "k1": (16, 1, 8, 8, True),
                          "t1": (1, 6, 8, 32, True),
                          "no_shared": (12, 3, 8, 16, False),
                          "k16": (5, 16, 20, 8, True)}[kind]
    weights = torch.linspace(1.0, 0.02, E) ** 3      # uneven loads
    idx = torch.stack([torch.multinomial(weights, K, generator=g)
                       for _ in range(T)])
    if kind == "one_expert":
        idx[:] = 2
    if kind == "first_on_one":
        rest = torch.stack([torch.randperm(E - 1, generator=g)[:K - 1] + 1
                            for _ in range(T)])
        idx = torch.cat([torch.zeros((T, 1), dtype=torch.long), rest], 1)
    return idx, D, shared


def _exact(shape, g, dtype=torch.float32):
    """Values k / 64 for integers |k| < 512: any sum of up to 17 is exact
    in float32, in any order."""
    return (torch.randint(-511, 512, shape, generator=g) / 64.0).to(dtype)


def _chain(out, token, T, shared, dtype):
    """The parent's combine: zeros, index_add_ by token, + shared as
    float32, one cast."""
    y = torch.zeros((T, out.shape[1]), dtype=torch.float32,
                    device=out.device)
    y.index_add_(0, token, out)
    if shared is not None:
        y += shared.float()
    return y.to(dtype)


ROUTINGS = ["uneven", "one_expert", "first_on_one", "k1", "t1", "no_shared",
            "k16"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ROUTINGS)
def test_plain_version_equals_the_index_add_chain(kind, dtype):
    idx, D, with_shared = _routing(kind, seed=len(kind))
    T, K = idx.shape
    _, token, pos = _sorted(idx)
    g = torch.Generator().manual_seed(7)
    out = _exact((T * K, D), g)
    shared = _exact((T, D), g, dtype) if with_shared else None
    want = _chain(out, token, T, shared, dtype)
    got = moe_combine_ref(out, pos, shared, dtype=dtype)
    assert got.dtype == dtype and tuple(got.shape) == (T, D)
    assert torch.equal(got, want)
    # the CPU route of the wrapper is the plain version
    assert torch.equal(kmod.moe_combine(out, pos, shared, dtype=dtype), got)


def test_plain_version_is_differentiable():
    """The CPU training path differentiates through the combine: each
    sorted row reaches exactly one token, so d(sum y)/d out is all ones,
    and the shared row's gradient too."""
    idx, D, _ = _routing("uneven", seed=3)
    T, K = idx.shape
    _, _, pos = _sorted(idx)
    g = torch.Generator().manual_seed(4)
    out = torch.randn((T * K, D), generator=g).requires_grad_()
    shared = torch.randn((T, D), generator=g).requires_grad_()
    kmod.moe_combine(out, pos, shared, dtype=torch.float32).sum().backward()
    assert torch.equal(out.grad, torch.ones_like(out))
    assert torch.equal(shared.grad, torch.ones_like(shared))


def _meta(T, K, D, M=None, *, shared=True, out_dtype=torch.float32,
          pos_dtype=torch.int32, shared_dtype=torch.bfloat16):
    M = T * K if M is None else M
    return (torch.empty((M, D), dtype=out_dtype, device="meta"),
            torch.empty((T, K), dtype=pos_dtype, device="meta"),
            torch.empty((T, D), dtype=shared_dtype, device="meta")
            if shared else None)


def test_meta_route_returns_an_empty_output_and_records_the_work():
    T, K, D = 8192, 10, 4096            # granite-4.0-h at 4 x 2,048 tokens
    out, pos, shared = _meta(T, K, D)
    with CostCounter() as cc:
        y = kmod.moe_combine(out, pos, shared, dtype=torch.bfloat16)
    assert y.device.type == "meta" and tuple(y.shape) == (T, D)
    assert y.dtype == torch.bfloat16
    # K7's rows (1.342 GB) and their positions read, the shared rows read
    # and the result written (67 MB each)
    assert kmod.min_bytes(T, K, D) == 1_476_722_688 == cc.bytes_accessed
    assert kmod.flops(T, K, D) == T * D * K == cc.flops
    out, pos, _ = _meta(0, K, D)
    assert tuple(kmod.moe_combine(out, pos, None,
                                  dtype=torch.bfloat16).shape) == (0, D)


@pytest.mark.parametrize("bad", ["out_bf16", "pos_int64", "shared_f32",
                                 "y_f32", "k17", "odd_d", "shared_rows",
                                 "out_1d", "pos_1d", "strided_out",
                                 "strided_shared", "no_rows"])
def test_cuda_checks_refuse_what_k9_does_not_take(bad):
    """The checks a CUDA call runs before it launches, reached here
    through the ``meta`` route, which runs the same checks."""
    T, K, D, M = 6, 4, 64, None
    kw = {}
    if bad == "out_bf16":
        kw["out_dtype"] = torch.bfloat16
    if bad == "pos_int64":
        kw["pos_dtype"] = torch.int64
    if bad == "shared_f32":
        kw["shared_dtype"] = torch.float32
    if bad == "k17":
        K = 17
    if bad == "odd_d":
        D = 60
    if bad == "no_rows":
        M = 0
    out, pos, shared = _meta(T, K, D, M, **kw)
    dtype = torch.float32 if bad == "y_f32" else torch.bfloat16
    if bad == "shared_rows":
        shared = shared[:-1]
    if bad == "out_1d":
        out = out.reshape(-1)
    if bad == "pos_1d":
        pos = pos.reshape(-1)
    if bad == "strided_out":
        out = out.t().contiguous().t()
    if bad == "strided_shared":
        shared = torch.empty((D, T), dtype=torch.bfloat16,
                             device="meta").t()
    err = TypeError if bad in ("out_bf16", "pos_int64", "shared_f32",
                               "y_f32") else ValueError
    with pytest.raises(err):
        kmod.moe_combine(out, pos, shared, dtype=dtype)


def _dropless_layer(dtype=torch.float32, device="cpu", *, T=24, D=32,
                    shared=True, seed=5):
    cfg = moe.MoEConfig(d_model=D, d_ff_expert=16, n_experts=8, top_k=3,
                        n_shared_experts=int(shared), d_ff_shared=24,
                        dropless=True)
    params = moe.moe_init(torch.Generator().manual_seed(seed), cfg,
                          dtype=dtype, device=device)
    x = torch.randn((2, T // 2, D), generator=torch.Generator()
                    .manual_seed(seed + 1)).to(dtype).to(device)
    return cfg, params, x


def _parent_combine(out, pos, shared=None, *, dtype):
    """``moe_combine``'s contract computed as the parent computed it."""
    T, K = pos.shape
    token = torch.empty(T * K, dtype=torch.long, device=out.device)
    token[pos.reshape(-1).long()] = torch.arange(
        T, device=out.device).repeat_interleave(K)
    return _chain(out, token, T, shared, dtype)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "none"])
def test_dropless_layer_combines_through_k9_and_no_index_add(shared,
                                                             monkeypatch):
    """``_moe_dropless`` makes one K9 call a layer, after the shared
    expert, dispatches no ``index_add``, and gives the parent's chain's
    output to float32 reordering."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, params, x = _dropless_layer(shared=shared)
    calls = []

    def spy(out, pos, sh=None, *, dtype):
        calls.append((tuple(out.shape), tuple(pos.shape), pos.dtype,
                      sh is not None, dtype))
        return kmod.moe_combine(out, pos, sh, dtype=dtype)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(func.__name__)
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(moe, "moe_combine", spy)
    with torch.no_grad(), Ops() as ops:
        y, _ = moe.moe_apply(params, cfg, x)
    T = x.shape[0] * x.shape[1]
    assert calls == [((T * 3, x.shape[2]), (T, 3), torch.int32, shared,
                      x.dtype)]
    assert not any("index_add" in n for n in ops.names), sorted(ops.names)
    monkeypatch.setattr(moe, "moe_combine", _parent_combine)
    with torch.no_grad():
        want, _ = moe.moe_apply(params, cfg, x)
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


def test_dropless_layer_keeps_its_gradients(monkeypatch):
    """With gradients on (the CPU training path) the layer's output and
    its router's gradient match the parent's chain to float32
    reordering."""
    cfg, params, x = _dropless_layer()
    params["router"]["kernel"].requires_grad_()
    y, aux = moe.moe_apply(params, cfg, x)
    (y.square().sum() + aux["moe_aux_loss"]).backward()
    got = params["router"]["kernel"].grad.clone()
    params["router"]["kernel"].grad = None
    monkeypatch.setattr(moe, "moe_combine", _parent_combine)
    want_y, want_aux = moe.moe_apply(params, cfg, x)
    (want_y.square().sum() + want_aux["moe_aux_loss"]).backward()
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, params["router"]["kernel"].grad,
                               rtol=1e-5, atol=1e-6)


# -- on the card --------------------------------------------------------


def _card_inputs(T, K, D, dev, *, seed, E=72):
    """A top-K routing of T tokens over E experts, sorted as the layer
    sorts it; K7-like float32 rows and a bf16 shared row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.topk(torch.randn((T, E), generator=g, device=dev), K,
                     dim=-1).indices
    _, token, pos = _sorted(idx)
    out = torch.randn((T * K, D), generator=g, device=dev) * 0.3
    shared = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    return out, pos, token, shared


def _excess(got, want32):
    """The largest |got - S| over its limit, 2^-8 |S| + 1e-6 max|S|."""
    limit = BF16_HALF_STEP * want32.abs() + REORDER * want32.abs().max()
    return ((got.float() - want32).abs() / limit).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("T,K,D", [(8192, 10, 4096), (4, 10, 4096),
                                   (33, 16, 256), (7, 1, 8)],
                         ids=["granite", "decode", "k16", "k1"])
@pytest.mark.parametrize("with_shared", [True, False],
                         ids=["shared", "none"])
def test_k9_matches_plain_on_card(cuda, T, K, D, with_shared):
    out, pos, _, shared = _card_inputs(T, K, D, cuda, seed=T + K)
    shared = shared if with_shared else None
    before = kmod.moe_combine.launches
    with torch.inference_mode():
        got = kmod.moe_combine(out, pos, shared, dtype=torch.bfloat16)
        want = moe_combine_ref(out, pos, shared, dtype=torch.float32)
        again = kmod.moe_combine(out, pos, shared, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert kmod.moe_combine.launches == before + 2
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, D)
    assert _excess(got, want) <= 1.0
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_k9_with_rolled_positions_fails_the_limit(cuda):
    """The planted fault: ``pos`` rolled by one over the flat (T K)
    array, so every token reads one neighbour's row."""
    T, K, D = 8192, 10, 4096
    out, pos, _, shared = _card_inputs(T, K, D, cuda, seed=1)
    with torch.inference_mode():
        want = moe_combine_ref(out, pos, shared, dtype=torch.float32)
        wrong = kmod.moe_combine(out, pos.reshape(-1).roll(1).view(T, K),
                                 shared, dtype=torch.bfloat16)
    assert _excess(wrong, want) > 100


@pytest.mark.gpu
def test_k9_refuses_on_card(cuda):
    out, pos, _, shared = _card_inputs(8, 4, 64, cuda, seed=2)
    with pytest.raises(TypeError):
        kmod.moe_combine(out, pos, shared.float(), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kmod.moe_combine(out[:, 1:-7], pos, None, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        kmod.moe_combine(out.requires_grad_(), pos, shared,
                         dtype=torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 512], ids=["decode", "prefill"])
def test_dropless_layer_on_card_matches_the_parent_chain(cuda, T,
                                                         monkeypatch):
    """The whole ``_moe_dropless`` layer in bf16 on the card (K7's
    smallest widths: D 256, F 128) against the same layer with the
    parent's zeros + ``index_add_`` + add + cast combine: the routing and
    K7 are the same, so each element lies within one bf16 step of the
    parent's (module docstring)."""
    D = 256
    cfg = moe.MoEConfig(d_model=D, d_ff_expert=128, n_experts=16, top_k=4,
                        n_shared_experts=1, d_ff_shared=256, dropless=True)
    params = moe.moe_init(torch.Generator().manual_seed(11), cfg,
                          dtype=torch.bfloat16, device=cuda)
    x = torch.randn((1, T, D), generator=torch.Generator().manual_seed(12)
                    ).to(torch.bfloat16).to(cuda)
    before = kmod.moe_combine.launches
    with torch.inference_mode():
        y, _ = moe.moe_apply(params, cfg, x)
        assert kmod.moe_combine.launches == before + 1
        monkeypatch.setattr(moe, "moe_combine", _parent_combine)
        want, _ = moe.moe_apply(params, cfg, x)
    w = want.float()
    limit = BF16_STEP * w.abs() + REORDER * w.abs().max()
    assert bool(((y.float() - w).abs() <= limit).all())
