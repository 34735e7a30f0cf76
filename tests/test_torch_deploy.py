"""The port's deployment manifest and served slice against the reference.

Manifests written by ``repro.deploy`` load in the port and round-trip
unchanged.  The slice end to end: the reference's parameters, converted
with ``params_from_jax``, serve 8 requests through the port's
``serving_pair`` on the CPU, and the actions match the reference's
``serving_pair`` within 1e-4 (fp32 sums in another order; a uint8 code may
flip by one where a feature sits at a .5 rounding boundary, which moves an
action by far less than that).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro import deploy as j_deploy
from repro.core.tuning import TunedPlan as JTunedPlan
from repro.rl import networks as j_networks
from repro_torch import deploy as t_deploy
from repro_torch.convert import params_from_jax
from repro_torch.core.tuning import TunedPlan
from repro_torch.rl import networks as t_networks
from repro_torch.schema import SchemaVersionError

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ACT_TOL = 1e-4


def _ref_manifest(**kw):
    return j_deploy.DeploymentConfig.standard(k=4, c_in=12, h=84, **kw)


@pytest.mark.parametrize("kw", [
    {},
    {"backend": "reference", "codec": "bf16", "max_batch": 4,
     "n_servers": 3, "router": "least_loaded", "head_placement": "fused"},
    {"tuning": JTunedPlan(backend="fused+head", tile_h=4, micro_batch=8,
                          time_s=1e-3, per_frame_s=2e-4, mode="interpret",
                          host="linux/x86_64/cpu/1", searched=5, pruned=3)},
])
def test_reference_manifest_loads_and_roundtrips(kw):
    ref = _ref_manifest(**kw)
    text = ref.to_json()
    cfg = t_deploy.DeploymentConfig.from_json(text)
    assert cfg.to_dict() == json.loads(text)
    assert t_deploy.DeploymentConfig.from_json(cfg.to_json()) == cfg
    # ... and the port's manifest loads in the reference
    assert j_deploy.DeploymentConfig.from_json(cfg.to_json()) == ref
    assert t_deploy.CONFIG_VERSION == j_deploy.CONFIG_VERSION == 2


def test_version1_manifest_loads_and_unknown_version_refused():
    d = _ref_manifest().to_dict()
    d.pop("tuning")
    d["version"] = 1
    cfg = t_deploy.DeploymentConfig.from_dict(d)
    assert cfg.tuning is None
    assert cfg == t_deploy.DeploymentConfig.from_dict(
        j_deploy.DeploymentConfig.from_dict(d).to_dict())
    d["version"] = 3
    with pytest.raises(SchemaVersionError, match="version 3"):
        t_deploy.DeploymentConfig.from_dict(d)


def test_validation_matches_reference():
    for bad in ({"router": "random"}, {"codec": "zip"},
                {"head_placement": "edge"}, {"max_batch": 0},
                {"tile_h": 0}, {"head_act": "gelu"}):
        with pytest.raises(ValueError):
            _ref_manifest(**bad).validate()
        with pytest.raises(ValueError):
            t_deploy.DeploymentConfig.standard(**bad).validate()
    assert set(t_deploy.ROUTERS) == set(__import__(
        "repro.serving.fleet", fromlist=["ROUTERS"]).ROUTERS)
    # aliases canonicalise as in the reference
    assert t_deploy.DeploymentConfig.standard(backend="fused_head").backend \
        == _ref_manifest(backend="fused_head").backend == "fused+head"


def test_tuning_block_honoured_only_when_measured_by_the_port():
    base = dict(backend="fused", tile_h=8)
    elsewhere = t_deploy.DeploymentConfig.standard(
        h=24, tuning=TunedPlan(backend="reference", tile_h=2, micro_batch=4,
                               mode="interpret"), **base)
    dep = t_deploy.Deployment.build(elsewhere, device="cpu")
    assert dep.backend.name == "fused" and dep.tile_h == 8
    assert any("measured elsewhere" in line for line in dep.build_log)
    here = dataclasses.replace(elsewhere, tuning=dataclasses.replace(
        elsewhere.tuning, mode="cuda"))
    dep = t_deploy.Deployment.build(here, device="cpu")
    assert dep.backend.name == "reference" and dep.tile_h == 2
    assert any("manifest TunedPlan" in line for line in dep.build_log)


@pytest.mark.parametrize("backend", ["grouped", "fused+stream", "fused_stream"])
def test_grouped_and_streamed_backends_build_and_match_reference(backend):
    """The grouped and streamed backends parse, build, and give the
    reference's encoder output for the same manifest and parameters (the
    reference's Pallas kernels in interpret mode, at 24x24)."""
    cfg = t_deploy.DeploymentConfig.standard(h=24, backend=backend,
                                             max_batch=4)
    assert t_deploy.DeploymentConfig.from_json(cfg.to_json()) == cfg
    dep = t_deploy.Deployment.build(cfg, device="cpu")
    assert dep.backend.name == cfg.backend
    ref_cfg = j_deploy.DeploymentConfig.from_json(cfg.to_json())
    j_dep = j_deploy.Deployment.build(ref_cfg)
    jparams = j_dep.init(jax.random.PRNGKey(2))
    obs = np.random.default_rng(2).random((5, 24, 24, 12), dtype=np.float32)
    want = np.asarray(j_dep.encoder.apply(jparams, jnp.asarray(obs)))
    with torch.inference_mode():
        got = dep.encoder.apply(params_from_jax(jparams, device="cpu"),
                                torch.from_numpy(obs))
    assert tuple(got.shape) == want.shape == (5, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_deploy.DeploymentConfig.standard()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_deploy.Deployment.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_deploy.Deployment.build(cfg, device="cuda")
    assert t_deploy.Deployment.build(cfg, device="cpu").device.type == "cpu"


def test_build_reports_the_shared_memory_plan():
    dep = t_deploy.Deployment.build(t_deploy.DeploymentConfig.standard(),
                                    device="cpu")
    assert dep.wire_bytes == 492 and dep.wire_bytes_batch() == 8 * 492
    assert dep.max_safe_batch >= dep.config.max_batch == 8
    tp = dep.plan.tile_plan(8)
    assert dep.build_log == (
        f"staging: halo tiles of {tp.tile_h}x{tp.tile_w} outputs, "
        f"{tp.n_tiles} a frame at max_batch=8; every layer's region in the "
        f"block's shared memory ({tp.smem_bytes} B a block, "
        f"{dep.plan.tile_plan(8, streamed=True).smem_bytes} B streamed); no "
        f"intermediate reaches device memory",)
    big = t_deploy.Deployment.build(
        t_deploy.DeploymentConfig.standard(c_in=4, h=400, max_batch=64),
        device="cpu")
    assert big.stream_chunk == big.max_safe_batch < 64
    assert any("halo tiles" in line for line in big.build_log)
    assert any("one wave of resident blocks" in line
               for line in big.build_log)
    k4 = big.plan.tile_plan(64, streamed=True)
    assert (f"stream plan: K4 tiles of {k4.tile_h}x{k4.tile_w}, "
            f"{k4.frames} frame(s) a layer pass, 1 input buffer "
            f"refilled after the first layer") in big.build_log[-1]


def test_cli_writes_and_verifies_a_manifest(tmp_path, capsys):
    out = tmp_path / "m.json"
    t_deploy.main(["--x", "32", "--backend", "reference", "--out", str(out),
                   "--device", "cpu", "--verify"])
    assert "verified" in capsys.readouterr().out
    cfg = t_deploy.DeploymentConfig.from_json(out.read_text())
    assert cfg.backend == "reference" and cfg.in_h == 32
    assert j_deploy.DeploymentConfig.from_json(out.read_text()).in_h == 32


@pytest.fixture(scope="module")
def served_reference():
    """The reference's full-size slice: k=4, c_in=12, X=84, fused, uint8,
    max_batch=8, with a squashed-actor head, serving 8 requests."""
    cfg = _ref_manifest(backend="fused", codec="uint8", max_batch=8)
    dep = j_deploy.Deployment.build(cfg)
    params = dep.init(jax.random.PRNGKey(0))
    head = j_networks.squashed_actor_init(jax.random.PRNGKey(1), 512, 6)
    obs = np.random.default_rng(0).random((8, 84, 84, 12), dtype=np.float32)
    client, server = dep.serving_pair(
        params, lambda z: j_networks.squashed_actor_mode(head, z))
    payloads = [client.encode_fn(jnp.asarray(obs[i:i + 1]))
                for i in range(8)]
    actions = np.stack([np.asarray(a) for a in server.serve(payloads)])
    return cfg, params, head, obs, payloads, actions


def test_slice_end_to_end_matches_reference(served_reference):
    ref_cfg, jparams, jhead, obs, jpayloads, jactions = served_reference
    cfg = t_deploy.DeploymentConfig.from_json(ref_cfg.to_json())
    dep = t_deploy.Deployment.build(cfg, device="cpu")
    params = params_from_jax(jparams, device="cpu")
    head = params_from_jax(jhead, device="cpu")
    client, server = dep.serving_pair(
        params, lambda z: t_networks.squashed_actor_mode(head, z))
    payloads = [client.encode_fn(torch.from_numpy(obs[i:i + 1]))
                for i in range(8)]
    actions = torch.stack(server.serve(payloads)).numpy()
    assert actions.shape == jactions.shape == (8, 6)
    np.testing.assert_allclose(actions, jactions, atol=ACT_TOL, rtol=0)
    for p, q in zip(payloads, jpayloads):
        assert p["data"].dtype == torch.uint8
        assert tuple(p["data"].shape) == q["data"].shape == (1, 11, 11, 4)
        assert p["scale"].shape == q["scale"].shape == ()
        codes = p["data"].numpy().astype(int) - np.asarray(q["data"], int)
        assert np.abs(codes).max() <= 1
        np.testing.assert_allclose(p["scale"].numpy(), np.asarray(q["scale"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(p["zero"].numpy(), np.asarray(q["zero"]),
                                   rtol=1e-5, atol=1e-6)


def test_fused_head_and_reference_backends_match_reference(served_reference):
    ref_cfg, jparams, _, obs, _, _ = served_reference
    params = params_from_jax(jparams, device="cpu")
    x = torch.from_numpy(obs[:2])
    j_dep = j_deploy.Deployment.build(dataclasses.replace(
        ref_cfg, backend="fused+head"))
    want = np.asarray(j_dep.encoder.apply(jparams, jnp.asarray(obs[:2])))
    for backend in ("fused+head", "reference", "xla"):
        dep = t_deploy.Deployment.build(
            dataclasses.replace(t_deploy.DeploymentConfig.from_json(
                ref_cfg.to_json()), backend=backend), device="cpu")
        with torch.inference_mode():
            z = dep.encoder.apply(params, x)
        np.testing.assert_allclose(z.numpy(), want, atol=1e-4, rtol=1e-4,
                                   err_msg=backend)


def test_params_from_jax_keeps_layouts_and_values(served_reference):
    _, jparams, _, _, _, _ = served_reference
    params = params_from_jax(jparams, device="cpu")
    assert tuple(params["edge"]["layer0"]["kernel"].shape) == (4, 4, 12, 16)
    assert tuple(params["server"]["proj"]["kernel"].shape) == (484, 512)
    for name in ("layer0", "layer1", "layer2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(
                params["edge"][name][leaf].numpy(),
                np.asarray(jparams["edge"][name][leaf]))


def test_edge_and_server_halves_match_reference():
    from repro.core.miniconv import standard_spec as j_standard_spec
    from repro_torch.core.miniconv import standard_spec
    jspec, spec = j_standard_spec(c_in=12, k=4), standard_spec(c_in=12, k=4)
    jp = j_networks.miniconv_encoder_init(jax.random.PRNGKey(4), jspec,
                                          h=32, w=40, feature_dim=64)
    tp = params_from_jax(jp, device="cpu")
    obs = np.random.default_rng(4).random((2, 32, 40, 12), dtype=np.float32)
    jf = j_networks.miniconv_edge_apply(jp["edge"], jspec, jnp.asarray(obs))
    jz = j_networks.miniconv_server_apply(jp["server"], jf)
    for mode in (False, "fused", "reference"):
        tf = t_networks.miniconv_edge_apply(tp["edge"], spec,
                                            torch.from_numpy(obs),
                                            use_kernel=mode)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5,
                                   rtol=1e-5, err_msg=str(mode))
        tz = t_networks.miniconv_server_apply(tp["server"], tf)
        assert tuple(tz.shape) == (2, 64)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-4,
                                   rtol=1e-4, err_msg=str(mode))


def test_heads_match_reference():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(3, 512)).astype(np.float32)
    act = rng.normal(size=(3, 6)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    cases = [
        ("squashed_actor", (512, 6), j_networks.squashed_actor_mode,
         t_networks.squashed_actor_mode, (feats,)),
        ("det_actor", (512, 6), j_networks.det_actor, t_networks.det_actor,
         (feats,)),
        ("q_critic", (512, 6), j_networks.q_critic, t_networks.q_critic,
         (feats, act)),
        ("v_critic", (512,), j_networks.v_critic, t_networks.v_critic,
         (feats,)),
        ("gaussian_actor", (512, 6), j_networks.gaussian_actor,
         t_networks.gaussian_actor, (feats,)),
    ]
    for name, dims, j_fn, t_fn, args in cases:
        jp = getattr(j_networks, f"{name}_init")(key, *dims)
        tp = params_from_jax(jp, device="cpu")
        want = j_fn(jp, *map(jnp.asarray, args))
        got = t_fn(tp, *map(torch.from_numpy, args))
        for g, w in zip(*(((got,), (want,)) if not isinstance(want, tuple)
                          else (got, want))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    # the port's initialisers give the reference's shapes
    gen = torch.Generator().manual_seed(0)
    tp = t_networks.squashed_actor_init(gen, 512, 6, device="cpu")
    jp = j_networks.squashed_actor_init(key, 512, 6)
    assert jax.tree.map(np.shape, jp) == \
        {"mlp": {k: {n: tuple(v.shape) for n, v in d.items()}
                 for k, d in tp["mlp"].items()}}


def test_perfstamp_rules_match_reference():
    from repro import perfstamp as j_perfstamp
    from repro_torch import perfstamp as t_perfstamp
    pairs = [({"mode": "cuda"}, {"mode": "cuda"}),
             ({"mode": "cuda"}, {"mode": "eager"}),
             ({"mode": "cuda"}, {}),
             ({"mode": "cuda", "transport": "sim"}, {"mode": "cuda"}),
             ({"mode": "cuda", "host": "a", "backend": "fused"},
              {"mode": "cuda", "host": "b", "backend": "xla"})]
    for a, b in pairs:
        assert t_perfstamp.mismatches(a, b) == j_perfstamp.mismatches(a, b)
    entry = t_perfstamp.stamp({"ms": 1.0}, backend="fused", device="cpu")
    assert entry["mode"] == "eager" and entry["backend"] == "fused"
    assert t_perfstamp.execution_mode("cuda") == "cuda"
    with pytest.raises(ValueError, match="execution modes"):
        t_perfstamp.check_comparable(entry, {**entry, "mode": "cuda"})
    t_perfstamp.check_comparable(entry, {**entry, "host": "other"})


def test_serving_measurements_and_service_model(served_reference):
    from repro.serving.server import BatchServiceModel as JModel
    from repro_torch.serving.server import BatchServiceModel, PolicyServer
    ref_cfg, jparams, _, obs, _, _ = served_reference
    dep = t_deploy.Deployment.build(
        t_deploy.DeploymentConfig.from_json(ref_cfg.to_json()), device="cpu")
    client, server = dep.serving_pair(params_from_jax(jparams, device="cpu"))
    x = torch.from_numpy(obs[:1])
    assert client.measure(x, iters=2, warmup=1) > 0
    assert client.measure_batch(x, batch=2, iters=2, warmup=1) > 0
    times = server.measure(client.encode_fn(x), batch_sizes=(1, 2),
                           iters=2, warmup=1)
    assert sorted(times) == [1, 2] and all(t > 0 for t in times.values())
    assert PolicyServer(dep.server_fn(params_from_jax(
        jparams, device="cpu"))).measure(client.encode_fn(x), iters=2) > 0
    points = ((1, 1e-3), (2, 1.5e-3), (8, 3e-3))
    for b in (1, 3, 8):
        assert BatchServiceModel(points)(b) == JModel(points)(b)
    with pytest.warns(RuntimeWarning, match="beyond the measured range"):
        assert BatchServiceModel(points)(10) == JModel(
            points, _warned=True)(10)
    with pytest.raises(ValueError, match="beyond the measured range"):
        BatchServiceModel(points, out_of_range="raise")(9)
