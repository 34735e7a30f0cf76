"""The port's Mamba-2 SSD layer (``repro_torch.nn.ssm``) against
``repro.nn.ssm`` on the CPU.

Parameters come from the reference's own ``ssm_init`` (converted with
``params_from_jax``); inputs from numpy with a seed.  Tolerances: f32
outputs, states and gradients 1e-5 of the largest magnitude of the
reference's (the two frameworks sum in other orders), and the f32 scan
1e-6 of the reference's float64 evaluation at a full 256-step chunk; the
decode's rolling conv buffers bit for bit (they hold the in-projection's
outputs, and at these widths both frameworks' matmuls round alike);
``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16 layer, whose outputs
agree to 5e-2 (a few bf16 ulps of outputs of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.nn import ssm as J

from repro_torch.convert import params_from_jax
from repro_torch.nn import ssm as T

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _cfgs(**kw):
    base = dict(d_model=32, d_state=16, head_dim=8, expand=2, n_groups=1,
                chunk=8)
    base.update(kw)
    return J.SSMConfig(**base), T.SSMConfig(**base)


def _ssd_inputs(cfg, b, S, seed):
    rng = np.random.default_rng(seed)
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, D, h0


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches(S, with_h0, groups):
    jcfg, cfg = _cfgs(n_groups=groups)
    *args, h0 = _ssd_inputs(cfg, 2, S, seed=S + 10 * groups)
    jy, jh = J.ssd_chunked(jcfg, *map(jnp.asarray, args),
                           h0=jnp.asarray(h0) if with_h0 else None)
    y, h = T.ssd_chunked(cfg, *map(torch.from_numpy, args),
                         h0=torch.from_numpy(h0) if with_h0 else None)
    assert y.shape == jy.shape and h.shape == jh.shape
    _close(y, jy)
    _close(h, jh)


def test_ssd_backward_is_finite_and_matches():
    """The -inf above the diagonal leaves no NaN in the gradients, and
    every input's gradient, ``A``'s among them, is within 1e-5 of the
    reference's f32 gradient and of its float64 one."""
    jcfg, cfg = _cfgs()
    x, dt, A, B, C, D, _ = _ssd_inputs(cfg, 1, 16, seed=3)

    def jgrads(dtype):
        def jloss(x, dt, A, B, C):
            return (J.ssd_chunked(jcfg, x, dt, A, B, C,
                                  jnp.asarray(D, dtype))[0] ** 2).mean()
        return [np.asarray(g) for g in jax.grad(
            jloss, argnums=(0, 1, 2, 3, 4))(*[jnp.asarray(a, dtype)
                                              for a in (x, dt, A, B, C)])]

    jg = jgrads(jnp.float32)
    with jax.enable_x64(True):
        jg64 = jgrads(jnp.float64)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y, _ = T.ssd_chunked(cfg, *ts, torch.from_numpy(D))
    grads = torch.autograd.grad((y ** 2).mean(), ts)
    for g, w, w64 in zip(grads, jg, jg64):
        assert torch.isfinite(g).all()
        assert w64.dtype == np.float64
        _close(g, w)
        _close(g, w64)


def test_ssd_at_a_full_chunk_matches_float64():
    """At the published 256-step chunk the f32 scan and its gradients stay
    within 1e-6 of the reference's scan in float64 (under
    ``jax.enable_x64``): each segment sum is summed on its own, not taken
    as a difference of two long cumulative sums."""
    jcfg, cfg = _cfgs(chunk=256)
    *args, _ = _ssd_inputs(cfg, 1, 256, seed=7)
    args[2] = -np.linspace(1.0, 16.0, cfg.n_heads).astype(np.float32)

    def jloss(*a):
        y, h = J.ssd_chunked(jcfg, *a)
        return (y ** 2).mean() + (h ** 2).mean(), (y, h)

    with jax.enable_x64(True):
        (_, (y64, h64)), g64 = jax.value_and_grad(
            jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
                *[jnp.asarray(a, jnp.float64) for a in args])
        want = [torch.from_numpy(np.array(t)) for t in (y64, h64, *g64)]
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, h = T.ssd_chunked(cfg, *ts)
    grads = torch.autograd.grad((y ** 2).mean() + (h ** 2).mean(), ts[:5])
    for got, w in zip((y, h, *grads), want):
        assert w.dtype == torch.float64
        assert float((got.detach().double() - w).abs().max()) <= \
            1e-6 * float(w.abs().max())


@pytest.fixture(scope="module")
def layer():
    jcfg, cfg = _cfgs()
    jp = J.ssm_init(jax.random.PRNGKey(0), jcfg)
    u = (np.random.default_rng(5).standard_normal((2, 16, cfg.d_model))
         * 0.5).astype(np.float32)
    return jcfg, cfg, jp, params_from_jax(jp, device="cpu"), u


def test_forward_with_state_matches(layer):
    jcfg, cfg, jp, tp, u = layer
    jo, jh = J.ssm_forward(jp, jcfg, jnp.asarray(u), return_state=True)
    o, h = T.ssm_forward(tp, cfg, torch.from_numpy(u), return_state=True)
    _close(o, jo)
    _close(h, jh)
    # h0 carries a state into the scan
    h0 = np.random.default_rng(6).standard_normal(
        tuple(jh.shape)).astype(np.float32) * 0.1
    _close(T.ssm_forward(tp, cfg, torch.from_numpy(u),
                         h0=torch.from_numpy(h0)),
           J.ssm_forward(jp, jcfg, jnp.asarray(u), h0=jnp.asarray(h0)))


def test_decode_steps_match(layer):
    jcfg, cfg, jp, tp, u = layer
    js = J.ssm_init_state(jcfg, 2)
    ts = T.ssm_init_state(cfg, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: tuple(v.shape) for k, v in js.items()}
    step = jax.jit(lambda p, x, s: J.ssm_decode_step(p, jcfg, x, s))
    outs = []
    for t in range(u.shape[1]):
        jo, js = step(jp, jnp.asarray(u[:, t:t + 1]), js)
        before = {k: v.clone() for k, v in ts.items()}
        o, ts_new = T.ssm_decode_step(tp, cfg, torch.from_numpy(
            u[:, t:t + 1]), ts)
        assert all(torch.equal(ts[k], before[k]) for k in ts), \
            "the functional step modified its input state"
        ts = ts_new
        _close(o, jo)
        _close(ts["h"], js["h"])
        np.testing.assert_array_equal(ts["conv"].numpy(),
                                      np.asarray(js["conv"]))
        outs.append(o)
    # decode against the full forward, the reference's own 1e-3
    _close(torch.cat(outs, 1), J.ssm_forward(jp, jcfg, jnp.asarray(u)),
           tol=1e-3)


def test_bf16_layer_keeps_its_scalars_f32():
    jcfg, cfg = _cfgs()
    jp = J.ssm_init(jax.random.PRNGKey(1), jcfg, dtype=jnp.bfloat16)
    tp = T.ssm_init(torch.Generator().manual_seed(1), cfg,
                    dtype=torch.bfloat16, device="cpu")
    for name in ("A_log", "D", "dt_bias"):
        assert jp[name].dtype == jnp.float32
        assert tp[name].dtype == torch.float32
    assert tp["in_proj"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6)
    conv = params_from_jax(jp, device="cpu")
    u = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (1, 8, cfg.d_model)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    got = T.ssm_forward(conv, cfg, u)
    want = J.ssm_forward(jp, jcfg, jnp.asarray(u.float().numpy())
                         .astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=5e-2, rtol=5e-2)
