"""The port's sharding rules, activation constraints and abstract inputs
against the reference's on the CPU, and its sharded steps on a 1x1 gloo
mesh against the reference's step functions on its 1x1 host mesh.

Exact: every leaf's partition spec (``param_spec`` in the three modes,
``cache_spec``, ``data_spec``) on the reference's production
``FakeMesh`` shapes for all ten configs at full width; the activation
spec against the one the reference's ``constrain`` hands to
``with_sharding_constraint`` (captured by monkeypatching it in the test;
the JAX package is not edited); ``abstract_params`` and
``input_specs_for`` paths, shapes and dtypes for all ten configs and
four shapes, on ``meta``.  The 1x1 steps of a reduced Qwen3 (2 layers,
d 256, f32, the reference's parameters through ``params_from_jax``)
equal the unsharded port bit for bit, and the reference within 1e-5 of
the loss and logits and 2·lr of each updated parameter (Adam's step
flips sign where the two frameworks round a near-zero gradient apart, as
in ``test_torch_lm_train``).
"""
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro import configs as j_configs
from repro.launch import steps as j_steps
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import registry as j_registry
from repro.models import sharding as j_shd
from repro.nn import constrain as j_constrain
from repro.nn.module import tree_paths as j_tree_paths

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.mesh import destroy, make_host_mesh
from repro_torch.models import registry
from repro_torch.models import sharding as shd
from repro_torch.models.config import ShapeConfig
from repro_torch.nn import constrain as t_constrain
from repro_torch.nn.module import tree_leaves, tree_paths, tree_unflatten
from repro_torch.train.optimizer import adamw

torch.set_num_threads(1)

ARCH_IDS = sorted(ARCHS)
# the archs the reference has: the port's own (granite-4.0-h-small) have no
# reference tree or input specs to compare with
REF_ARCH_IDS = sorted(j_registry.ARCH_IDS)
LR = 3e-4


class FakeMesh:
    """The reference's duck-typed mesh (tests/test_sharding.py)."""

    def __init__(self, shape):
        self.shape = shape


PROD = FakeMesh({"data": 16, "model": 16})
PROD_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": PROD, "multi": PROD_MP}


def _spec(p):
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return dict(j_tree_paths(j_registry.abstract_params(
        j_registry.build_model(j_configs.get_config(arch)))))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dict(tree_paths(registry.abstract_params(
        registry.build_model(get_config(arch)))))


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _same_leaves(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for path, leaf in port.items():
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(ref[path].shape), path
        assert _dtype(leaf) == str(ref[path].dtype), path


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_abstract_params_equal_the_reference(arch):
    _same_leaves(_port_params(arch), _ref_params(arch))


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    for shape_id in registry.SHAPE_IDS:
        port = dict(tree_paths(registry.input_specs(arch, shape_id)))
        ref = dict(j_tree_paths(j_registry.input_specs(arch, shape_id)))
        _same_leaves(port, ref)


def test_abstract_params_draw_nothing_at_full_width():
    registry.abstract_params(registry.build_model(get_config("qwen3-0.6b")))
    model = registry.build_model(get_config("llama4-scout-17b-a16e"))
    t0 = time.perf_counter()
    params = registry.abstract_params(model)
    took = time.perf_counter() - t0
    n = sum(x.numel() for x in tree_leaves(params))
    assert n == 107_769_861_120 and took < 1.0, (n, took)
    assert all(x.device.type == "meta" for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    for path, leaf in _port_params(arch).items():
        for mesh in MESHES.values():
            for mode in ("fsdp_tp", "tp_only", "ep_model"):
                got = shd.param_spec(path, leaf.shape, mesh, mode=mode)
                want = j_shd.param_spec(path, leaf.shape, mesh, mode=mode)
                assert _spec(got) == _spec(want), (path, mode, mesh.shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_data_specs_equal_the_reference(arch):
    for shape_id in ("decode_32k", "long_500k"):
        B = SHAPES[shape_id].global_batch
        caches = registry.input_specs(arch, shape_id)["caches"]
        for path, leaf in tree_paths(caches):
            for mesh in MESHES.values():
                assert _spec(shd.cache_spec(path, leaf.shape, mesh, B)) == \
                    _spec(j_shd.cache_spec(path, leaf.shape, mesh, B)), path
    for mesh in MESHES.values():
        for rank in (1, 2, 3):
            for batch in (None, 1, 16, 32, 128, 256):
                assert _spec(shd.data_spec(mesh, rank, batch)) == \
                    _spec(j_shd.data_spec(mesh, rank, batch))
        assert shd.batch_axes(mesh) == j_shd.batch_axes(mesh)


def test_axis_sizes_read_every_kind_of_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    assert t_constrain.axis_sizes(PROD_MP) == PROD_MP.shape
    assert t_constrain.axis_sizes({"data": 4}) == {"data": 4}

    class Mesh:           # a DeviceMesh's shape is a tuple
        shape = (2, 16, 16)
        mesh_dim_names = ("pod", "data", "model")
    assert t_constrain.axis_sizes(Mesh()) == PROD_MP.shape
    assert hasattr(DeviceMesh, "mesh_dim_names")


def test_placements_shard_one_dim_over_pod_then_data():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    P = shd.P
    assert shd.placements(P(("pod", "data"), None, "model"), Mesh()) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(P(None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements(P(), Mesh()) == (Replicate(),) * 3
    assert shd.replicated(Mesh()) == (Replicate(),) * 3
    assert repr(P("data", None)) == "P('data', None)"


ACT_CASES = [
    ((256, 4096, 16, 128), ("batch", None, "model", None), 256),
    ((256, 4096, 8, 128), ("batch", None, "model", None), 256),
    ((32, 1, 40, 128), ("batch", None, None, None), 32),
    ((128, 16, 1, 32768), ("batch", None, None, "model"), 128),
    ((256, 4096, 151936), ("batch", None, "model"), 256),
    ((256, 4096, 50280), ("batch", None, "model"), 256),
    ((64, 4096, 1024), ("batch", None, None), 256),
    ((1, 1, 1024), ("batch", None, None), 1),
    ((2048, 512, 5120), ("data", None, None), 256),
    ((2048, 16, 40, 5120), ("data", "model", None, None), 256),
    ((60, 4, 5, 7), ("data", "model", None, None), 256),
    ((256, 16, 512), ("batch", "model", None), 256),
    ((16, 16), ("model", "model"), 16),
    ((32, 32), ("batch", "data"), 32),
]


@pytest.mark.parametrize("shape,dims,batch", ACT_CASES)
def test_activation_spec_equals_the_reference_constraint(
        shape, dims, batch, monkeypatch):
    seen = []
    monkeypatch.setattr(j_constrain, "NamedSharding",
                        lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    x = jax.ShapeDtypeStruct(shape, jnp.float32)
    for mesh in MESHES.values():
        seen.clear()
        with j_constrain.activation_sharding(mesh, batch):
            j_constrain.constrain(x, dims)
        got = t_constrain.activation_spec(shape, dims, mesh.shape, batch)
        assert _spec(got) == _spec(seen[0]), (shape, dims, mesh.shape)


def test_constrain_is_the_identity_outside_the_context():
    x = torch.ones(4, 8, 16)
    assert t_constrain.constrain(x, ("batch", None, "model")) is x
    assert t_constrain.constrain_act(x) is x
    assert shd.constrain_act(x) is x
    assert t_constrain.gathered(x) is x and t_constrain.reduced(x) is x
    with t_constrain.activation_sharding(PROD, 4):
        assert t_constrain.constrain(x, ("batch", None)) is x   # rank
        assert t_constrain.constrain(3.0, ("batch",)) == 3.0
        with t_constrain.on_local_tensors():
            assert t_constrain.constrain(x, ("batch", None, None)) is x


# ---------------------------------------------------------------------------
# the sharded steps on a 1x1 gloo mesh
# ---------------------------------------------------------------------------

ARCH = "qwen3-0.6b"
B, S = 4, 32


def _reduced_overrides():
    cfg = get_config(ARCH)
    red = cfg.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(cfg, f.name)}


OV = _reduced_overrides()
TINY = {kind: ShapeConfig(sid, S, B, kind) for sid, kind in
        (("train_4k", "train"), ("prefill_32k", "prefill"),
         ("decode_32k", "decode"))}


@pytest.fixture(scope="module")
def host():
    mesh = make_host_mesh(device="cpu")
    jcfg = j_configs.get_config(ARCH).reduced()
    jp = j_registry.build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jp, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S)) \
        .astype(np.int32)
    yield mesh, params, jp, toks
    destroy()


def _ref_step(kind, monkeypatch, **over):
    monkeypatch.setitem(j_configs.SHAPES, TINY[kind].name,
                        j_configs.SHAPES[TINY[kind].name].__class__(
                            TINY[kind].name, S, B, kind))
    return j_steps.make_step(ARCH, TINY[kind].name,
                             j_host_mesh((1, 1), ("data", "model")),
                             overrides={**OV, **over})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _local(tree):
    return [t.to_local() for t in tree_leaves(tree)]


def _train(host, over=None):
    mesh, params, _, toks = host
    bundle = steps.make_step(ARCH, "train_4k", mesh,
                             overrides={**OV, **(over or {})},
                             shape=TINY["train"])
    opt = adamw(LR, clip_norm=1.0)
    return bundle.run(mesh, params, opt.init(params),
                      {"tokens": torch.from_numpy(toks)})


def test_train_step_matches_the_reference_and_the_unsharded_port(
        host, monkeypatch):
    mesh, params, jp, toks = host
    new_p, new_o, met = _train(host)
    # the unsharded port at the same parameters: bit for bit
    model = registry.build_model(get_config(ARCH).reduced())
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten(params, leaves),
                         {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    opt = adamw(LR, clip_norm=1.0)
    want_p, _ = opt.update(params, opt.init(params),
                           tree_unflatten(params, list(grads)))
    assert torch.equal(met["loss"].to_local(), loss.detach())
    assert all(torch.equal(a, b) for a, b in
               zip(_local(new_p), tree_leaves(want_p)))
    assert new_o.step.to_local().item() == 1
    # the reference's train step on its 1x1 host mesh
    jb = _ref_step("train", monkeypatch)
    jopt = j_steps.adamw(LR, clip_norm=1.0)
    jnew, _, jmet = jax.jit(jb.fn)(jp, jopt.init(jp),
                                   {"tokens": jnp.asarray(toks)})
    assert _rel(met["loss"].to_local().numpy(), jmet["loss"]) < 1e-5
    assert _rel(met["ce"].to_local().numpy(), jmet["ce"]) < 1e-5
    for a, b in zip(_local(new_p), jax.tree.leaves(jnew)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2 * LR


def test_two_microbatches_match_one(host):
    _, _, m1 = _train(host)
    new2, _, m2 = _train(host, {"microbatches": 2})
    new1 = _train(host)[0]
    assert _rel(m2["loss"].to_local().numpy(),
                m1["loss"].to_local().numpy()) < 1e-5
    for a, b in zip(_local(new2), _local(new1)):
        assert (a - b).abs().max().item() <= 2 * LR


def test_prefill_step_matches_the_reference_and_the_unsharded_port(
        host, monkeypatch):
    mesh, params, jp, toks = host
    bundle = steps.make_step(ARCH, "prefill_32k", mesh, overrides=OV,
                             shape=TINY["prefill"])
    got = bundle.run(mesh, params, {"tokens": torch.from_numpy(toks)})
    model = registry.build_model(get_config(ARCH).reduced())
    with torch.no_grad():
        want = model.forward(params, torch.from_numpy(toks),
                             last_only=True)[0][:, -1]
    assert torch.equal(got.to_local(), want)
    jb = _ref_step("prefill", monkeypatch)
    jgot = jax.jit(jb.fn)(jp, {"tokens": jnp.asarray(toks)})
    assert _rel(got.to_local().numpy(), jgot) < 1e-5


def test_decode_step_matches_the_reference_and_the_unsharded_port(
        host, monkeypatch):
    mesh, params, jp, toks = host
    model = registry.build_model(get_config(ARCH).reduced())
    bundle = steps.make_step(ARCH, "decode_32k", mesh, overrides=OV,
                             shape=TINY["decode"])
    token = torch.from_numpy(toks[:, :1])
    idx = torch.tensor(5, dtype=torch.int32)
    caches = model.init_cache(B, S, torch.float32, device="cpu")
    plain = model.init_cache(B, S, torch.float32, device="cpu")
    for c, p in zip(tree_leaves(caches), tree_leaves(plain)):
        c.normal_(generator=torch.Generator().manual_seed(1))
        p.copy_(c)
    before = [c.clone() for c in tree_leaves(caches)]
    logits, new = bundle.run(mesh, params, token, caches, idx)
    want, _ = model.decode_step(params, token, plain, idx)
    assert torch.equal(logits.to_local(), want)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(caches), tree_leaves(plain)))
    # the reference's serve step from the same caches (it returns new ones)
    jb = _ref_step("decode", monkeypatch)
    jmodel = j_registry.build_model(j_configs.get_config(ARCH).reduced())
    jc = jax.tree.unflatten(
        jax.tree.structure(jmodel.init_cache(B, S, jnp.float32)),
        [jnp.asarray(c.numpy()) for c in before])
    jlogits, jnew = jax.jit(jb.fn)(jp, jnp.asarray(toks[:, :1]), jc,
                                   jnp.int32(5))
    assert _rel(logits.to_local().numpy(), jlogits) < 1e-5
    for a, b in zip(tree_leaves(caches), jax.tree.leaves(jnew)):
        assert _rel(a.numpy(), b) < 1e-5
