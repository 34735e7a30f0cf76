"""The port's encoder tiers and kernel wrappers against the reference.

On the CPU every port tier computes with its kernels' plain PyTorch
versions; the reference runs its Pallas kernels in interpret mode.  The
same numpy inputs and the reference's converted parameters go to both.

Tolerances: features atol=rtol=1e-5 and the projection z 1e-4, in fp32.
The two frameworks sum each convolution's taps, and the projection's 484
or more terms, in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.core import miniconv as j_miniconv
from repro.kernels import miniconv_pass as j_kernels
from repro.kernels import ops as j_ops
from repro_torch.convert import params_from_jax
from repro_torch.core import miniconv as t_miniconv
from repro_torch.kernels import miniconv_pass as t_kernels
from repro_torch.kernels import ops as t_ops

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

FEAT_TOL = 1e-5
Z_TOL = 1e-4


def _spec(mod, name):
    L = mod.LayerSpec
    if name == "standard":
        return mod.standard_spec(c_in=12, k=4)
    if name == "acts":      # every activation, a c_out=6 last layer
        return mod.MiniConvSpec((L(4, 2, 12, 16, "relu"),
                                 L(3, 2, 16, 16, "sigmoid"),
                                 L(3, 2, 16, 6, "linear")))
    if name == "single":    # one stride-1 layer, c_out % 4 != 0
        return mod.MiniConvSpec((L(3, 1, 8, 6, "sigmoid"),))
    raise KeyError(name)


# (spec, H, W): even and odd inputs
CASES = [("standard", 24, 24), ("acts", 25, 19), ("single", 17, 23)]


def _setup(name, h, w, *, batch=2, seed=0, head_dim=None):
    js = _spec(j_miniconv, name)
    ts = _spec(t_miniconv, name)
    jparams = j_miniconv.miniconv_init(jax.random.PRNGKey(seed), js)
    # non-zero biases, so the bias path is compared too
    rng = np.random.default_rng(seed)
    for i, l in enumerate(js.layers):
        jparams[f"layer{i}"]["bias"] = jnp.asarray(
            rng.normal(0, 0.1, (l.c_out,)).astype(np.float32))
    x = rng.random((batch, h, w, js.layers[0].c_in), dtype=np.float32)
    head = None
    if head_dim is not None:
        flat = js.plan(h, w).flat_features
        head = {"kernel": rng.normal(0, 0.05, (flat, head_dim))
                .astype(np.float32),
                "bias": rng.normal(0, 0.1, (head_dim,)).astype(np.float32)}
    return js, ts, jparams, params_from_jax(jparams, device="cpu"), x, head


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("mode", ["xla", "fused", "reference", "grouped",
                                  "fused+stream"])
@pytest.mark.parametrize("name,h,w", CASES)
def test_features_match_reference_xla(name, h, w, mode):
    js, ts, jp, tp, x, _ = _setup(name, h, w)
    want = j_miniconv.miniconv_apply(jp, js, jnp.asarray(x), use_kernel="xla")
    got = t_miniconv.miniconv_apply(tp, ts, torch.from_numpy(x),
                                    use_kernel=mode)
    assert tuple(got.shape) == want.shape
    _close(got, want, FEAT_TOL)


@pytest.mark.parametrize("tile_h", [1, 3, 8])
@pytest.mark.parametrize("name,h,w", CASES)
def test_fused_matches_reference_fused_kernel(name, h, w, tile_h):
    """The reference's Pallas fused kernel at each tile height against the
    port's fused tier, where tile_h does not change the result."""
    js, ts, jp, tp, x, _ = _setup(name, h, w, seed=1)
    want = j_miniconv.miniconv_apply(jp, js, jnp.asarray(x),
                                     use_kernel="fused", tile_h=tile_h)
    got = t_miniconv.miniconv_apply(tp, ts, torch.from_numpy(x),
                                    use_kernel="fused", tile_h=tile_h)
    _close(got, want, FEAT_TOL)


@pytest.mark.parametrize("head_act", ["relu", "sigmoid"])
@pytest.mark.parametrize("d", [200, 512])
@pytest.mark.parametrize("name,h,w", CASES[:2])
def test_head_epilogue_matches_reference(name, h, w, d, head_act):
    js, ts, jp, tp, x, head = _setup(name, h, w, seed=2, head_dim=d)
    jf, jz = j_miniconv.miniconv_apply(
        jp, js, jnp.asarray(x), use_kernel="fused", tile_h=3,
        head={k: jnp.asarray(v) for k, v in head.items()}, head_act=head_act)
    th = {k: torch.from_numpy(v) for k, v in head.items()}
    for mode in ("fused", "xla"):
        tf, tz = t_miniconv.miniconv_apply(tp, ts, torch.from_numpy(x),
                                           use_kernel=mode, head=th,
                                           head_act=head_act)
        assert tuple(tz.shape) == (x.shape[0], d)
        _close(tf, jf, FEAT_TOL)
        _close(tz, jz, Z_TOL)
    # (w, b) tuple form, as the reference accepts it
    _, tz = t_miniconv.miniconv_apply(tp, ts, torch.from_numpy(x),
                                      use_kernel="fused",
                                      head=(th["kernel"], th["bias"]),
                                      head_act=head_act)
    _close(tz, jz, Z_TOL)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (4, 2)])
@pytest.mark.parametrize("h,w", [(16, 16), (17, 23)])
def test_pass_wrapper_matches_reference_pass_kernel(kernel, stride, h, w):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.random((2, h, w, 8), dtype=np.float32)
    wt = rng.normal(0, 0.2, (kernel, kernel, 8, 4)).astype(np.float32)
    b = rng.normal(0, 0.1, (4,)).astype(np.float32)
    want = j_kernels.miniconv_pass(jnp.asarray(x), jnp.asarray(wt),
                                   jnp.asarray(b), stride=stride)
    got = t_kernels.miniconv_pass(torch.from_numpy(x), torch.from_numpy(wt),
                                  torch.from_numpy(b), stride=stride)
    assert tuple(got.shape) == want.shape
    _close(got, want, FEAT_TOL)


@pytest.mark.parametrize("g", [0, 8])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (4, 2)])
def test_pass_wrapper_takes_a_weight_group_view(kernel, stride, g):
    """K2 given its group's weights as the non-contiguous view
    ``w[..., g:g + 4]`` of a 12-channel layer weight (as the ``reference``
    tier passes them), against the reference's pass kernel on the same
    group."""
    rng = np.random.default_rng(kernel * 10 + stride + g)
    x = rng.random((2, 17, 23, 8), dtype=np.float32)
    wt = rng.normal(0, 0.2, (kernel, kernel, 8, 12)).astype(np.float32)
    b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    want = j_kernels.miniconv_pass(jnp.asarray(x),
                                   jnp.asarray(wt[..., g:g + 4]),
                                   jnp.asarray(b[g:g + 4]), stride=stride)
    view = torch.from_numpy(wt)[..., g:g + 4]
    assert not view.is_contiguous()
    got = t_kernels.miniconv_pass(torch.from_numpy(x), view,
                                  torch.from_numpy(b)[g:g + 4],
                                  stride=stride)
    assert tuple(got.shape) == want.shape
    _close(got, want, FEAT_TOL)


@pytest.mark.parametrize("c_out", [4, 6, 16])
def test_per_pass_layer_matches_reference(c_out):
    rng = np.random.default_rng(c_out)
    x = rng.random((2, 17, 23, 8), dtype=np.float32)
    wt = rng.normal(0, 0.2, (3, 3, 8, c_out)).astype(np.float32)
    b = rng.normal(0, 0.1, (c_out,)).astype(np.float32)
    want = j_ops.miniconv_layer(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(b), stride=2)
    got = t_ops.miniconv_layer(torch.from_numpy(x), torch.from_numpy(wt),
                               torch.from_numpy(b), stride=2)
    _close(got, want, FEAT_TOL)
    _close(t_ops.same_pad(torch.from_numpy(x), 4, 2),
           j_ops.same_pad(jnp.asarray(x), 4, 2), 0.0)


def test_encoder_wrapper_matches_reference_at_full_size():
    """The fused wrapper at the served shape (84x84x12, k=4) with the
    484x512 projection, against the reference's fused kernel."""
    js, ts, jp, tp, x, head = _setup("standard", 84, 84, batch=2, seed=3,
                                     head_dim=512)
    jplan, tplan = js.plan(84), ts.plan(84)
    ws = [jp[f"layer{i}"]["kernel"] for i in range(3)]
    bs = [jp[f"layer{i}"]["bias"] for i in range(3)]
    jf, jz = j_kernels.miniconv_encoder(
        jnp.asarray(x), ws, bs, jplan, head_w=jnp.asarray(head["kernel"]),
        head_b=jnp.asarray(head["bias"]))
    tf, tz = t_kernels.miniconv_encoder(
        torch.from_numpy(x), [tp[f"layer{i}"]["kernel"] for i in range(3)],
        [tp[f"layer{i}"]["bias"] for i in range(3)], tplan,
        head_w=torch.from_numpy(head["kernel"]),
        head_b=torch.from_numpy(head["bias"]))
    assert tuple(tf.shape) == (2, 11, 11, 4) and tuple(tz.shape) == (2, 512)
    _close(tf, jf, FEAT_TOL)
    _close(tz, jz, Z_TOL)


def test_cpu_path_launches_no_kernel():
    """The counters count kernel launches only: on CPU tensors the
    wrappers compute with the plain versions and launch nothing."""
    _, ts, _, tp, x, _ = _setup("standard", 24, 24)
    wrappers = (t_kernels.miniconv_encoder, t_kernels.miniconv_pass,
                t_kernels.miniconv_layer_grouped,
                t_kernels.miniconv_encoder_stream)
    for f in wrappers:
        f.launches = 0
    for mode in ("fused", "reference", "grouped"):
        t_miniconv.miniconv_apply(tp, ts, torch.from_numpy(x),
                                  use_kernel=mode)
    t_miniconv.miniconv_apply(tp, ts, torch.from_numpy(x),
                              use_kernel="fused", stream_chunk=1)
    assert [f.launches for f in wrappers] == [0, 0, 0, 0]


def test_wrappers_refuse_bad_inputs():
    _, ts, _, tp, x, _ = _setup("standard", 24, 24)
    plan = ts.plan(24)
    ws = [tp[f"layer{i}"]["kernel"] for i in range(3)]
    bs = [tp[f"layer{i}"]["bias"] for i in range(3)]
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="does not match the plan"):
        t_kernels.miniconv_encoder(xt[:, :20], ws, bs, plan)
    with pytest.raises(ValueError, match="head weight"):
        t_kernels.miniconv_encoder(xt, ws, bs, plan,
                                   head_w=torch.zeros(10, 4))
    with pytest.raises(ValueError, match="one device"):
        t_kernels.miniconv_encoder(xt.to("meta"), ws, bs, plan)
    with pytest.raises(ValueError, match="w \\(kh,kw,C,4\\)"):
        t_kernels.miniconv_pass(xt, torch.zeros(3, 3, 12, 6), torch.zeros(6))
    with pytest.raises(ValueError, match="plan was built"):
        t_miniconv.miniconv_apply(tp, ts, xt, use_kernel="fused",
                                  plan=ts.plan(32))
    with pytest.raises(ValueError, match="C_out%4==0"):
        t_kernels.miniconv_layer_grouped(xt, torch.zeros(3, 3, 12, 6),
                                         torch.zeros(6))
    with pytest.raises(ValueError, match="chunk_b"):
        t_kernels.miniconv_encoder_stream(xt, ws, bs, plan, chunk_b=0)
    with pytest.raises(ValueError, match="does not match the plan"):
        t_kernels.miniconv_encoder_stream(xt[:, :20], ws, bs, plan,
                                          chunk_b=1)
