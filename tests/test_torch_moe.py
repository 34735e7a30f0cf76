"""The port's MoE layer (``repro_torch.nn.moe``) against ``repro.nn.moe``
on the CPU.

Parameters come from the reference's own ``moe_init`` (converted with
``params_from_jax``); inputs from numpy with a seed.  Tolerances: outputs,
the auxiliary loss, the router entropy and gradients 1e-5 in f32 (the two
frameworks sum in other orders); the routing — each (token, k) pair's
expert and whether capacity dropped it — equal.  The seeds give no
near-ties in the top-k (a tie's order is the one thing the two top-k
functions may settle differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.nn.moe import MoEConfig as JMoEConfig
from repro.nn.moe import _capacity as j_capacity
from repro.nn.moe import _group_size as j_group_size
from repro.nn.moe import moe_apply as j_moe_apply
from repro.nn.moe import moe_init as j_moe_init

from repro_torch.models.config import port_only_dict
from repro_torch.convert import params_from_jax
from repro_torch.nn.module import tree_leaves, tree_unflatten
from repro_torch.nn.moe import MoEConfig, _capacity, _group_size, \
    moe_apply, moe_init

torch.set_num_threads(1)

TOL = 1e-5


def _cfgs(**kw):
    base = dict(d_model=32, d_ff_expert=48, n_experts=4, top_k=2,
                group_size=16)
    base.update(kw)
    return JMoEConfig(**base), MoEConfig(**base)


def _setup(seed=0, shape=(2, 16), **kw):
    jcfg, cfg = _cfgs(**kw)
    jp = j_moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 100).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, params_from_jax(jp, device="cpu"), x


def _ref_routing(jp, jcfg, x):
    """The reference's routing arithmetic (``repro/nn/moe.py:107-137``):
    the expert of each (token, k) pair and whether it is kept."""
    T = x.shape[0] * x.shape[1]
    E, K = jcfg.n_experts_padded, jcfg.top_k
    G = j_group_size(jcfg, T)
    C = j_capacity(jcfg, G)
    xt = jnp.asarray(x).reshape(T // G, G, -1)
    logits = xt @ jp["router"]["kernel"]
    if E > jcfg.n_experts:
        logits = jnp.where(jnp.arange(E) >= jcfg.n_experts, -jnp.inf,
                           logits)
    probs = jax.nn.softmax(logits, -1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E)
    pos = jnp.cumsum(onehot.reshape(T // G, G * K, E), 1) \
        .reshape(onehot.shape) - onehot
    keep = ((pos < C) & (onehot > 0)).any(-1)
    return np.asarray(idx), np.asarray(keep), np.asarray(probs)


def _min_margin(probs, K):
    """Smallest gap between the k-th and the (k+1)-th probability."""
    s = -np.sort(-probs, -1)
    return float((s[..., :K] - s[..., 1:K + 1]).min())


@pytest.mark.parametrize("case", [
    dict(), dict(n_shared_experts=1), dict(n_shared_experts=2,
                                           shared_expert_gate=True),
    dict(n_experts=6, pad_experts_to=8), dict(top_k=1, n_shared_experts=1),
], ids=["routed", "shared", "shared_gate", "padded", "top1_shared"])
def test_apply_matches_the_reference(case):
    jcfg, cfg, jp, tp, x = _setup(seed=1, capacity_factor=8.0, **case)
    assert cfg.n_experts_padded == jcfg.n_experts_padded
    y, aux = moe_apply(tp, cfg, torch.from_numpy(x))
    jy, jaux = j_moe_apply(jp, jcfg, jnp.asarray(x))
    idx, keep, probs = _ref_routing(jp, jcfg, x)
    assert _min_margin(probs, cfg.top_k) > 1e-5
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), idx)
    np.testing.assert_array_equal(aux["keep"].numpy(), keep)
    assert keep.all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    for k in ("moe_aux_loss", "router_entropy"):
        assert aux[k].dtype == torch.float32
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=TOL,
                                   rtol=TOL)
    if cfg.n_experts_padded > cfg.n_experts:
        assert (aux["expert_idx"] < cfg.n_experts).all()
        assert float(aux["probs"][..., cfg.n_experts:].abs().max()) == 0.0


@pytest.mark.parametrize("cf,top_k", [(0.5, 2), (0.25, 1), (1.0, 2)])
def test_binding_capacity_drops_the_same_pairs(cf, top_k):
    jcfg, cfg, jp, tp, x = _setup(seed=2, shape=(1, 64), capacity_factor=cf,
                                  top_k=top_k, group_size=32,
                                  n_shared_experts=1)
    y, aux = moe_apply(tp, cfg, torch.from_numpy(x))
    jy, jaux = j_moe_apply(jp, jcfg, jnp.asarray(x))
    idx, keep, probs = _ref_routing(jp, jcfg, x)
    assert _min_margin(probs, top_k) > 1e-5
    assert not keep.all(), "capacity did not bind"
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), idx)
    np.testing.assert_array_equal(aux["keep"].numpy(), keep)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), atol=TOL,
                               rtol=TOL)


def test_a_dropped_pair_takes_no_slot():
    """Capacity 1 with every token on one expert: only the first token of
    each group reaches it; the rest get the shared path alone."""
    _, cfg, _, tp, x = _setup(seed=3, shape=(1, 8), capacity_factor=0.01,
                              top_k=1, group_size=8)
    tp["router"]["kernel"].zero_()
    tp["router"]["kernel"][:, 2] = 1.0
    x = np.abs(x)                       # every token prefers expert 2
    y, aux = moe_apply(tp, cfg, torch.from_numpy(x))
    assert _capacity(cfg, 8) == 1
    np.testing.assert_array_equal(aux["keep"][0, :, 0].numpy(),
                                  [True] + [False] * 7)
    assert float(y[0, 1:].abs().max()) == 0.0 and float(y[0, 0].abs().max()) > 0


@pytest.mark.parametrize("n_tokens", [1, 7, 64, 128, 1000, 1024])
@pytest.mark.parametrize("E,K,cf,G", [(60, 4, 1.25, 512), (16, 1, 1.25, 512),
                                      (4, 2, 0.5, 16), (60, 4, 15.0, 128)])
def test_capacity_and_group_size_equal_the_reference(n_tokens, E, K, cf, G):
    jcfg, cfg = _cfgs(n_experts=E, top_k=K, capacity_factor=cf, group_size=G)
    assert _group_size(cfg, n_tokens) == j_group_size(jcfg, n_tokens)
    assert _capacity(cfg, n_tokens) == j_capacity(jcfg, n_tokens)


def test_gradients_match_jax_grad():
    jcfg, cfg, jp, tp, x = _setup(seed=4, n_shared_experts=1,
                                  shared_expert_gate=True,
                                  capacity_factor=1.0)

    def jloss(p, xx):
        y, aux = j_moe_apply(p, jcfg, xx)
        return (y ** 2).mean() + 0.01 * aux["moe_aux_loss"]

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe_apply(tree_unflatten(tp, leaves), cfg, xt)
    loss = (y ** 2).mean() + 0.01 * aux["moe_aux_loss"]
    grads = torch.autograd.grad(loss, leaves + [xt])
    np.testing.assert_allclose(float(loss.detach()), float(jl), atol=TOL,
                               rtol=TOL)
    for g, jgl in zip(grads, jax.tree.leaves(jg) + [jgx]):
        jgl = np.asarray(jgl)
        scale = max(np.abs(jgl).max(), 1e-30)
        assert np.abs(g.numpy() - jgl).max() <= TOL * scale
    # the router learns through the gate values
    router_g = grads[[i for i, t in enumerate(tree_leaves(tp))
                      if t is tp["router"]["kernel"]][0]]
    assert float(router_g.abs().max()) > 0


def test_bf16_activations_route_through_an_f32_router():
    """A bf16 model keeps its router in f32 and routes the bf16
    activations exactly as the reference does; the experts compute in
    bf16 (tolerance 3e-2, a few bf16 ulps of outputs of order 1)."""
    jcfg, cfg, jp, _, x = _setup(seed=5, n_shared_experts=1,
                                 shared_expert_gate=True)
    jp16 = {k: v if k == "router" else
            jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
            for k, v in jp.items()}
    tp16 = params_from_jax(jp16, device="cpu")
    assert tp16["router"]["kernel"].dtype == torch.float32
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    y, aux = moe_apply(tp16, cfg, torch.from_numpy(
        np.array(x16.astype(jnp.float32))).to(torch.bfloat16))
    jy, _ = j_moe_apply(jp16, jcfg, x16)
    idx, _, _ = _ref_routing(jp16, jcfg, np.asarray(
        x16.astype(jnp.float32)))
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), idx)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def test_init_matches_the_reference_tree():
    jcfg, cfg = _cfgs(n_experts=6, pad_experts_to=8, n_shared_experts=2,
                      shared_expert_gate=True)
    jp = j_moe_init(jax.random.PRNGKey(0), jcfg)
    tp = moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")

    def shapes(t, get):
        return {k: shapes(v, get) if isinstance(v, dict) else get(v)
                for k, v in t.items()}

    assert shapes(tp, lambda v: tuple(v.shape)) == \
        shapes(jp, lambda v: tuple(v.shape))
    assert tp["router"]["kernel"].dtype == torch.float32
    # each expert's own fan-in: std 1/sqrt(d_model)
    std = float(tp["experts"]["gate"]["kernel"].std())
    assert abs(std * np.sqrt(cfg.d_model) - 1) < 0.1
    assert port_only_dict(cfg) == dataclasses.asdict(jcfg)
