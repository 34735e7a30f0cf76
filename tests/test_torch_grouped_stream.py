"""The port's grouped layer (K3) and streamed encoder (K4) against the
reference, and the tuned serving slice.

On the CPU the wrappers compute with their kernels' plain versions; the
reference runs its Pallas kernels in interpret mode at small sizes (at most
24x24: interpret mode steps through the grid in Python).  The same numpy
inputs and the reference's converted parameters go to both.

Tolerances: features atol=rtol=1e-5 and the projection z 1e-4, in fp32
(the two frameworks sum each convolution's taps, and the projection's
terms, in different orders); served actions 1e-4, as in
``test_torch_deploy.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro import deploy as j_deploy
from repro.core import miniconv as j_miniconv
from repro.kernels import miniconv_pass as j_kernels
from repro.kernels import ops as j_ops
from repro.rl import networks as j_networks
from repro_torch import deploy as t_deploy
from repro_torch.convert import params_from_jax
from repro_torch.core import miniconv as t_miniconv
from repro_torch.core.tuning import TunedPlan
from repro_torch.kernels import miniconv_pass as t_kernels
from repro_torch.kernels import ops as t_ops
from repro_torch.rl import networks as t_networks

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

FEAT_TOL = 1e-5
Z_TOL = 1e-4
ACT_TOL = 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# K3: one layer, every output group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride,h,w,c_in,c_out", [
    (3, 1, 16, 16, 8, 8),
    (3, 2, 17, 23, 8, 16),
    (4, 2, 24, 24, 12, 16),
])
def test_grouped_wrapper_matches_reference_grouped_kernel(kernel, stride, h,
                                                          w, c_in, c_out):
    rng = np.random.default_rng(kernel * 100 + h)
    x = rng.random((2, h, w, c_in), dtype=np.float32)
    wt = rng.normal(0, 0.2, (kernel, kernel, c_in, c_out)).astype(np.float32)
    b = rng.normal(0, 0.1, (c_out,)).astype(np.float32)
    want = j_kernels.miniconv_layer_grouped(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=stride,
        interpret=True)
    got = t_kernels.miniconv_layer_grouped(
        torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
        stride=stride)
    assert tuple(got.shape) == want.shape
    _close(got, want, FEAT_TOL)


@pytest.mark.parametrize("kernel,stride,h,w,c_in,c_out", [
    (3, 2, 17, 23, 8, 16),
    (4, 2, 24, 24, 12, 16),
])
def test_pass_group_views_match_reference_grouped_kernel(kernel, stride, h,
                                                         w, c_in, c_out):
    """K2 on each group's non-contiguous ``w[..., g:g + 4]`` view, the
    groups concatenated, against the reference's grouped kernel in
    interpret mode; and equal to the port's K3 bit for bit."""
    rng = np.random.default_rng(kernel * 100 + h + 1)
    x = rng.random((2, h, w, c_in), dtype=np.float32)
    wt = rng.normal(0, 0.2, (kernel, kernel, c_in, c_out)).astype(np.float32)
    b = rng.normal(0, 0.1, (c_out,)).astype(np.float32)
    want = j_kernels.miniconv_layer_grouped(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=stride,
        interpret=True)
    xt, wv, bv = map(torch.from_numpy, (x, wt, b))
    parts = [t_kernels.miniconv_pass(xt, wv[..., g:g + 4], bv[g:g + 4],
                                     stride=stride)
             for g in range(0, c_out, 4)]
    got = torch.cat(parts, dim=-1)
    _close(got, want, FEAT_TOL)
    assert torch.equal(got, t_kernels.miniconv_layer_grouped(
        xt, wv, bv, stride=stride))


@pytest.mark.parametrize("c_out", [4, 6, 13])
def test_grouped_layer_matches_reference_including_ragged_groups(c_out):
    """``ops.miniconv_layer(fused_groups=True)`` pads a c_out % 4 != 0
    layer to whole groups and slices it back, as the reference does."""
    rng = np.random.default_rng(c_out)
    x = rng.random((2, 17, 23, 8), dtype=np.float32)
    wt = rng.normal(0, 0.2, (3, 3, 8, c_out)).astype(np.float32)
    b = rng.normal(0, 0.1, (c_out,)).astype(np.float32)
    want = j_ops.miniconv_layer(jnp.asarray(x), jnp.asarray(wt),
                                jnp.asarray(b), stride=2, fused_groups=True,
                                interpret=True)
    got = t_ops.miniconv_layer(torch.from_numpy(x), torch.from_numpy(wt),
                               torch.from_numpy(b), stride=2,
                               fused_groups=True)
    assert tuple(got.shape) == want.shape == (2, 9, 12, c_out)
    _close(got, want, FEAT_TOL)
    per_pass = t_ops.miniconv_layer(torch.from_numpy(x), torch.from_numpy(wt),
                                    torch.from_numpy(b), stride=2)
    assert torch.equal(got, per_pass)


def test_grouped_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="C_out%4==0"):
        t_kernels.miniconv_layer_grouped(x, torch.zeros(3, 3, 4, 6),
                                         torch.zeros(6))
    with pytest.raises(ValueError, match="shared memory"):
        t_kernels.miniconv_layer_grouped(x, torch.zeros(4, 4, 4, 1024),
                                         torch.zeros(1024))
    t_kernels.miniconv_layer_grouped.launches = 0
    t_kernels.miniconv_layer_grouped(x, torch.zeros(3, 3, 4, 8),
                                     torch.zeros(8))
    assert t_kernels.miniconv_layer_grouped.launches == 0   # plain on CPU


# ---------------------------------------------------------------------------
# K4: the streamed encoder
# ---------------------------------------------------------------------------

CHUNK = 3


@pytest.fixture(scope="module")
def stream_setup():
    js = j_miniconv.standard_spec(c_in=12, k=4)
    ts = t_miniconv.standard_spec(c_in=12, k=4)
    jp = j_miniconv.miniconv_init(jax.random.PRNGKey(7), js)
    rng = np.random.default_rng(7)
    for i, l in enumerate(js.layers):
        jp[f"layer{i}"]["bias"] = jnp.asarray(
            rng.normal(0, 0.1, (l.c_out,)).astype(np.float32))
    tp = params_from_jax(jp, device="cpu")
    jplan, tplan = js.plan(12), ts.plan(12)
    head = {"kernel": rng.normal(0, 0.05, (tplan.flat_features, 20))
            .astype(np.float32),
            "bias": rng.normal(0, 0.1, (20,)).astype(np.float32)}
    x = rng.random((4 * CHUNK, 12, 12, 12), dtype=np.float32)
    return js, ts, jp, tp, jplan, tplan, head, x


@pytest.mark.parametrize("with_head", [False, True])
@pytest.mark.parametrize("B", [1, CHUNK, CHUNK + 1, 4 * CHUNK])
def test_stream_wrapper_matches_reference_stream(stream_setup, B, with_head):
    """B in {1, chunk, chunk+1, 4*chunk}, against both of the reference's
    streaming strategies (one launch per chunk, and the chunk-grid kernel)."""
    js, ts, jp, tp, jplan, tplan, head, x = stream_setup
    n = len(js.layers)
    jws = [jp[f"layer{i}"]["kernel"] for i in range(n)]
    jbs = [jp[f"layer{i}"]["bias"] for i in range(n)]
    tws = [tp[f"layer{i}"]["kernel"] for i in range(n)]
    tbs = [tp[f"layer{i}"]["bias"] for i in range(n)]
    jh = {k: jnp.asarray(v) for k, v in head.items()} if with_head else {}
    th = {k: torch.from_numpy(v) for k, v in head.items()} if with_head \
        else {}
    t_kernels.miniconv_encoder_stream.launches = 0
    got = t_kernels.miniconv_encoder_stream(
        torch.from_numpy(x[:B]), tws, tbs, tplan, chunk_b=CHUNK,
        head_w=th.get("kernel"), head_b=th.get("bias"))
    assert t_kernels.miniconv_encoder_stream.launches == 0   # plain on CPU
    whole = t_kernels.miniconv_encoder(
        torch.from_numpy(x[:B]), tws, tbs, tplan, head_w=th.get("kernel"),
        head_b=th.get("bias"))
    for pipelined in (False, True):
        want = j_kernels.miniconv_encoder_stream(
            jnp.asarray(x[:B]), jws, jbs, jplan, chunk_b=CHUNK,
            head_w=jh.get("kernel"), head_b=jh.get("bias"),
            pipelined=pipelined)
        if with_head:
            assert tuple(got[1].shape) == want[1].shape == (B, 20)
            _close(got[0], want[0], FEAT_TOL)
            _close(got[1], want[1], Z_TOL)
        else:
            assert tuple(got.shape) == want.shape == (B, 2, 2, 4)
            _close(got, want, FEAT_TOL)
    if with_head:
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    else:
        assert torch.equal(got, whole)


def test_stream_chunk_is_checked_and_apply_streams(stream_setup):
    _, ts, _, tp, _, tplan, _, x = stream_setup
    xt = torch.from_numpy(x)
    ws = [tp[f"layer{i}"]["kernel"] for i in range(3)]
    bs = [tp[f"layer{i}"]["bias"] for i in range(3)]
    with pytest.raises(ValueError, match="chunk_b"):
        t_kernels.miniconv_encoder_stream(xt, ws, bs, tplan, chunk_b=0)
    ref = t_miniconv.miniconv_apply(tp, ts, xt, use_kernel="fused")
    for kw in ({"use_kernel": "fused", "stream_chunk": CHUNK},
               {"use_kernel": "fused+stream"},
               {"use_kernel": "fused_stream", "stream_chunk": 5}):
        assert torch.equal(t_miniconv.miniconv_apply(tp, ts, xt, **kw), ref)


# ---------------------------------------------------------------------------
# The tuned serving slice
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_xla_reference():
    """The reference's full-size slice built with ``backend="xla"``: k=4,
    c_in=12, X=84, uint8, max_batch=8, squashed-actor head, 8 requests."""
    cfg = j_deploy.DeploymentConfig.standard(k=4, c_in=12, h=84,
                                             backend="xla", max_batch=8)
    dep = j_deploy.Deployment.build(cfg)
    params = dep.init(jax.random.PRNGKey(0))
    head = j_networks.squashed_actor_init(jax.random.PRNGKey(1), 512, 6)
    obs = np.random.default_rng(0).random((8, 84, 84, 12), dtype=np.float32)
    client, server = dep.serving_pair(
        params, lambda z: j_networks.squashed_actor_mode(head, z))
    payloads = [client.encode_fn(jnp.asarray(obs[i:i + 1]))
                for i in range(8)]
    actions = np.stack([np.asarray(a) for a in server.serve(payloads)])
    z = np.asarray(dep.encoder.apply(params, jnp.asarray(obs)))
    return cfg, params, head, obs, actions, z


@pytest.mark.parametrize("backend,micro", [("grouped", 8),
                                           ("fused+stream", 3)])
def test_tuned_slice_serves_like_the_reference(served_xla_reference, backend,
                                               micro):
    """A manifest carrying a port-measured (``cuda``) TunedPlan builds the
    tuned backend on the CPU, serves 8 decisions within 1e-4 of the
    reference, and its encoder matches on the whole batch."""
    ref_cfg, jparams, jhead, obs, jactions, jz = served_xla_reference
    cfg = dataclasses.replace(
        t_deploy.DeploymentConfig.from_json(ref_cfg.to_json()),
        backend="fused", tuning=TunedPlan(
            backend=backend, tile_h=8, micro_batch=micro, time_s=1e-4,
            per_frame_s=2e-5, mode="cuda",
            host="linux/x86_64/NVIDIA H100 80GB HBM3/8"))
    dep = t_deploy.Deployment.build(cfg, device="cpu")
    assert dep.backend.name == backend
    assert any("manifest TunedPlan" in line for line in dep.build_log)
    assert dep.stream_chunk == (micro if backend == "fused+stream" else None)
    params = params_from_jax(jparams, device="cpu")
    head = params_from_jax(jhead, device="cpu")
    client, server = dep.serving_pair(
        params, lambda z: t_networks.squashed_actor_mode(head, z))
    payloads = [client.encode_fn(torch.from_numpy(obs[i:i + 1]))
                for i in range(8)]
    actions = torch.stack(server.serve(payloads)).numpy()
    np.testing.assert_allclose(actions, jactions, atol=ACT_TOL, rtol=0)
    with torch.inference_mode():
        z = dep.encoder.apply(params, torch.from_numpy(obs))
    _close(z, jz, Z_TOL)
