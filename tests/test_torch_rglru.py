"""The port's RG-LRU block (``repro_torch.nn.rglru``) against
``repro.nn.rglru`` on the CPU.

Parameters come from the reference's own ``rglru_init`` (converted with
``params_from_jax``); inputs from numpy with a seed.  The port's scan is
a log-depth doubling scan, the reference's ``associative_scan`` another
tree of the same compositions.  Tolerances: f32 scans, outputs and
states 1e-5 of the largest magnitude of the reference's; the decode's
rolling conv buffers bit for bit (they hold the in-projection's outputs,
and at these widths both frameworks' matmuls round alike).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.nn import rglru as J

from repro_torch.convert import params_from_jax
from repro_torch.nn import rglru as T

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _scan_inputs(S, seed, W=8):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, S, W))))).astype(
        np.float32)
    bx = rng.standard_normal((2, S, W)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32)
    return a, bx, h0


@pytest.mark.parametrize("S", [1, 16, 13, 128])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches(S, with_h0):
    a, bx, h0 = _scan_inputs(S, seed=S)
    got = T.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx),
                       h0=torch.from_numpy(h0) if with_h0 else None)
    want = J.rglru_scan(jnp.asarray(a), jnp.asarray(bx),
                        h0=jnp.asarray(h0) if with_h0 else None)
    _close(got, want)
    # and the recurrence itself, step by step
    h = h0 if with_h0 else np.zeros_like(h0)
    for t in range(S):
        h = a[:, t] * h + bx[:, t]
    _close(got[:, -1], h)


def test_scan_gradients_match():
    a, bx, h0 = _scan_inputs(13, seed=1)

    def jloss(a, bx, h0):
        return (J.rglru_scan(a, bx, h0=h0) ** 2).mean()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (a, bx, h0)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (a, bx, h0)]
    grads = torch.autograd.grad((T.rglru_scan(*ts[:2], h0=ts[2]) ** 2)
                                .mean(), ts)
    for g, w in zip(grads, jg):
        _close(g, w)


def test_scan_takes_log_depth_steps(monkeypatch):
    calls = []
    real = T._shift
    monkeypatch.setattr(T, "_shift", lambda t, s, f: calls.append(s)
                        or real(t, s, f))
    a, bx, _ = _scan_inputs(128, seed=2)
    T.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    assert sorted(set(calls)) == [1, 2, 4, 8, 16, 32, 64]
    assert len(calls) == 2 * 7


@pytest.fixture(scope="module")
def block():
    jcfg = J.RGLRUConfig(d_model=32, d_rnn=48)
    cfg = T.RGLRUConfig(d_model=32, d_rnn=48)
    jp = J.rglru_init(jax.random.PRNGKey(0), jcfg)
    u = (np.random.default_rng(3).standard_normal((2, 12, 32)) * 0.5) \
        .astype(np.float32)
    return jcfg, cfg, jp, params_from_jax(jp, device="cpu"), u


def test_forward_matches(block):
    jcfg, cfg, jp, tp, u = block
    jo, jh = J.rglru_forward(jp, jcfg, jnp.asarray(u), return_state=True)
    o, h = T.rglru_forward(tp, cfg, torch.from_numpy(u), return_state=True)
    assert h.dtype == torch.float32 and tuple(h.shape) == (2, 48)
    _close(o, jo)
    _close(h, jh)
    h0 = (np.random.default_rng(4).standard_normal((2, 48)) * 0.1) \
        .astype(np.float32)
    _close(T.rglru_forward(tp, cfg, torch.from_numpy(u),
                           h0=torch.from_numpy(h0)),
           J.rglru_forward(jp, jcfg, jnp.asarray(u), h0=jnp.asarray(h0)))


def test_decode_steps_match(block):
    jcfg, cfg, jp, tp, u = block
    js = J.rglru_init_state(jcfg, 2)
    ts = T.rglru_init_state(cfg, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: tuple(v.shape) for k, v in js.items()}
    step = jax.jit(lambda p, x, s: J.rglru_decode_step(p, jcfg, x, s))
    outs = []
    for t in range(u.shape[1]):
        jo, js = step(jp, jnp.asarray(u[:, t:t + 1]), js)
        o, ts = T.rglru_decode_step(tp, cfg, torch.from_numpy(u[:, t:t + 1]),
                                    ts)
        _close(o, jo)
        _close(ts["h"], js["h"])
        np.testing.assert_array_equal(ts["conv"].numpy(),
                                      np.asarray(js["conv"]))
        outs.append(o)
    # decode against the full forward, the reference's own 1e-3
    _close(torch.cat(outs, 1), J.rglru_forward(jp, jcfg, jnp.asarray(u)),
           tol=1e-3)


def test_init_spans_the_griffin_range():
    cfg = T.RGLRUConfig(d_model=16, d_rnn=512)
    p = T.rglru_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    a_c = torch.exp(-8.0 * torch.nn.functional.softplus(p["lambda"]))
    assert p["lambda"].dtype == torch.float32
    assert 0.9 <= float(a_c.min()) and float(a_c.max()) <= 0.999 + 1e-6
    jp = J.rglru_init(jax.random.PRNGKey(0), J.RGLRUConfig(d_model=16,
                                                           d_rnn=512))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(p) == shapes(jp)
