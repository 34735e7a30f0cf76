"""The MoE, Mamba-2 (SSM) and RG-LRU (hybrid) decoder families in the port
against the reference on the CPU.

Reduced configs (``ArchConfig.reduced()``: 2 layers, d 256, f32) of
qwen2-moe-a2.7b, llama4-scout-17b-a16e, mamba2-130m and
recurrentgemma-9b, with the reference's own ``DecoderModel.init``
parameters converted with ``params_from_jax``; tokens from numpy with a
seed.  Tolerances, each relative to the largest magnitude of the
reference's values: forward logits, the loss and ``moe_aux_loss`` 1e-5;
gradients 1e-5 of each leaf's largest (the SSD's ``A_log`` against the
reference's float64 evaluation, and 5e-5 against its f32 one, see the
test); 16 decode steps against the reference's jitted ``decode_step``
1e-5 in the logits and the recurrent states; decode against the port's
own forward at the reference's 2e-2 (``tests/test_models.py``), the MoE
at a capacity that drops nothing; the split against the monolith with the
f32 codec bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.configs import ARCHS as ARCHS_J
from repro.models.registry import get_model as j_get_model
from repro.models.transformer import DecoderModel as JDecoder

from repro_torch.models.config import port_only_dict
from repro_torch.configs import ARCHS as ARCHS_T
from repro_torch.convert import params_from_jax
from repro_torch.core.wire import get_codec
from repro_torch.launch import serve as t_serve
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import DecoderModel
from repro_torch.nn.module import tree_leaves, tree_paths, tree_unflatten

torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "mamba2-130m",
         "recurrentgemma-9b"]
TOL = 1e-5
DECODE_VS_FORWARD = 2e-2


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(3, vocab, shape,
                                                dtype=np.int32)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


_MODELS = {}


def _models(arch):
    """(port cfg, port model, port params, ref model, ref params)."""
    if arch not in _MODELS:
        jcfg, jmodel = j_get_model(arch, reduced=True)
        jp = jmodel.init(jax.random.PRNGKey(0))
        cfg, model = get_model(arch, reduced=True)
        assert port_only_dict(cfg) == dataclasses.asdict(jcfg)
        _MODELS[arch] = (cfg, model, params_from_jax(jp, device="cpu"),
                         jmodel, jp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch):
    cfg, model, tp, jmodel, jp = _models(arch)
    tok = _tokens((2, 16), cfg.vocab)
    got, aux = model.forward(tp, torch.from_numpy(tok))
    want, jaux = jmodel.forward(jp, jnp.asarray(tok))
    assert got.shape == (2, 16, cfg.vocab)
    _close(got, want)
    _close(aux["moe_aux_loss"], jaux["moe_aux_loss"])
    assert (float(aux["moe_aux_loss"]) > 0) == (cfg.moe is not None)


def _grads(model, params, tok):
    leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
    loss, aux = model.loss(tree_unflatten(params, leaves),
                           {"tokens": torch.from_numpy(tok)}, remat=True)
    return loss, aux, torch.autograd.grad(loss, leaves)


A_LOG_VS_F32 = 5e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    """Every gradient against ``jax.value_and_grad``'s, but the SSD's
    ``A_log``: the reference's segment sums are differences of one
    cumulative sum, which cancel and leave its own f32 ``A_log`` gradient
    1.7e-5 of the leaf's largest from its float64 evaluation.  The port
    sums each segment on its own (``kernels.ref._segsum``), so that leaf is
    held at 1e-5 against the reference's loss differentiated under
    ``jax.enable_x64`` on float64 parameters (the segment sums then run in
    float64), and at ``A_LOG_VS_F32`` against the reference's f32
    gradient; the test prints both packages' distances."""
    cfg, model, tp, jmodel, jp = _models(arch)
    tok = _tokens((2, 16), cfg.vocab, seed=2)

    def ref_grads(p):
        return jax.value_and_grad(
            lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tok)},
                                  remat=False), has_aux=True)(p)

    (jl, jaux), jg = ref_grads(jp)
    loss, aux, grads = _grads(model, tp, tok)
    _close(loss, jl)
    _close(aux["moe_aux_loss"], jaux["moe_aux_loss"])
    want = {n: w for (n, _), w in zip(tree_paths(tp), jax.tree.leaves(jg))}
    if cfg.ssm is not None:
        with jax.enable_x64(True):
            _, jg64 = ref_grads(jax.tree.map(
                lambda a: a.astype(jnp.float64), jp))
            want64 = {n: np.asarray(w) for (n, _), w in
                      zip(tree_paths(tp), jax.tree.leaves(jg64))}
        for (n, _), g in zip(tree_paths(tp), grads):
            if n.endswith("A_log"):
                w64 = want64[n]
                assert w64.dtype == np.float64
                scale = float(np.abs(w64).max())
                port = float(np.abs(g.numpy() - w64).max()) / scale
                ref = float(np.abs(np.asarray(want[n]) - w64).max()) / scale
                print(f"{n} gradient, relative to the reference in float64:"
                      f" port {port:.3g}, reference f32 {ref:.3g}")
                _close(g, want[n], A_LOG_VS_F32)
                want[n] = w64
    for (n, _), g in zip(tree_paths(tp), grads):
        assert torch.isfinite(g).all()
        _close(g, want[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_reference_step(arch):
    cfg, model, tp, jmodel, jp = _models(arch)
    tok = _tokens((2, 16), cfg.vocab, seed=3)
    jc = jmodel.init_cache(2, 16, jnp.float32)
    caches = model.init_cache(2, 16, torch.float32, device="cpu")
    step = jax.jit(jmodel.decode_step)
    index = torch.zeros((), dtype=torch.int64)
    for t in range(16):
        jlg, jc = step(jp, jnp.asarray(tok[:, t:t + 1]), jc, jnp.int32(t))
        lg, caches = model.decode_step(tp, torch.from_numpy(tok[:, t:t + 1]),
                                       caches, index)
        index += 1
        _close(lg, jlg)
    for got, want in zip(tree_leaves(caches), jax.tree.leaves(jc)):
        _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_forward(arch):
    """The reference's own check (``tests/test_models.py``), at 2e-2; the
    MoE at ``capacity_factor = n_experts / top_k``, where no pair drops
    (a decode step routes one token a group, the forward 16)."""
    cfg, model, tp, _, _ = _models(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        model = DecoderModel(cfg)
    tok = torch.from_numpy(_tokens((1, 16), cfg.vocab, seed=4))
    full, _ = model.forward(tp, tok)
    caches = model.init_cache(1, 16, torch.float32, device="cpu")
    outs = []
    for t in range(16):
        lg, caches = model.decode_step(tp, tok[:, t:t + 1], caches, t)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.detach().numpy(),
                               atol=DECODE_VS_FORWARD,
                               rtol=DECODE_VS_FORWARD)


def _split_cfg(configs, arch):
    """The reduced config with a ``"scan"`` subtree of 2 super-blocks, as
    the split needs (recurrentgemma's reduced() unrolls its two blocks),
    from ``configs`` (either package's ``ARCHS``)."""
    cfg = configs[arch].reduced()
    if cfg.n_pattern < 2:
        cfg = dataclasses.replace(cfg, pattern=cfg.remainder, n_pattern=2,
                                  remainder=(), n_layers=4)
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_split_equals_the_monolith_with_the_f32_codec(arch):
    """The halves' parity with the reference is the forward's (the same
    blocks); here the split itself: edge, the f32 codec and the server
    half give the monolith's logits bit for bit."""
    cfg = _split_cfg(ARCHS_T, arch)
    jcfg = _split_cfg(ARCHS_J, arch)
    assert port_only_dict(cfg) == dataclasses.asdict(jcfg)
    model = DecoderModel(cfg)
    tp = params_from_jax(JDecoder(jcfg).init(jax.random.PRNGKey(5)),
                         device="cpu")
    tok = torch.from_numpy(_tokens((2, 16), cfg.vocab, seed=5))
    codec = get_codec("float32")
    te, ts = model.split_params(tp, 1)
    assert model.edge_forward(te, tok).dtype == torch.float32
    split = model.server_forward(ts, codec.decode(
        codec.encode(model.edge_forward(te, tok)), dtype=torch.float32))
    mono, _ = model.forward(tp, tok)
    # the server half leaves the logit softcap out, as the reference's
    assert (cfg.logit_softcap is not None) == (arch == "recurrentgemma-9b")
    assert torch.equal(model._softcap(split), mono)


@pytest.mark.parametrize("kind,arch", [("ssm", "mamba2-130m"),
                                       ("rec", "recurrentgemma-9b")])
def test_decode_step_writes_the_states_in_place(kind, arch):
    """``decode_step``'s caller keeps the caches it passed in, ignoring
    what the step returns, as ``decode_step`` itself treats
    ``block_decode``: the recurrent states must change in those tensors."""
    cfg, model, tp, _, _ = _models(arch)
    caches = model.init_cache(1, 16, torch.float32, device="cpu")
    states = [c for k, c in caches.items() if k.endswith(kind)] + [
        c for k, c in caches.get("scan", {}).items() if k.endswith(kind)]
    assert states
    tok = torch.from_numpy(_tokens((1, 16), cfg.vocab, seed=6))
    for t in range(16):
        model.decode_step(tp, tok[:, t:t + 1], caches, t)
    for st in states:
        for name in ("h", "conv"):
            assert float(st[name].abs().max()) > 0, \
                f"the {kind} cache's {name} stayed zero"


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_build_split_serves_the_family(arch):
    """The reduced MoE and SSM configs split at their first super-block
    (the reduced hybrid has no ``"scan"`` subtree to split, in either
    package)."""
    cfg, edge_fn, server_fn, mono_fn, tokens, wire, raw = \
        t_serve.build_split(arch, reduced=True, edge_segments=1,
                            codec_name="uint8", batch=1, seq=16,
                            device="cpu")
    logits = server_fn(edge_fn(tokens))
    assert logits.shape == mono_fn(tokens).shape == (1, 16, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert (wire, raw) == (16 * cfg.d_model + 8, 16 * 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree(arch):
    cfg, model, _, jmodel, _ = _models(arch)
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def spec(t):
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return tuple(t.shape), str(t.dtype).removeprefix("torch.")

    assert spec(own) == spec(want)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_recurrent_states_stay_f32_in_a_bf16_cache(arch):
    cfg, model, _, jmodel, _ = _models(arch)
    caches = model.init_cache(1, 16, torch.bfloat16, device="cpu")
    want = jax.eval_shape(lambda: jmodel.init_cache(1, 16, jnp.bfloat16))
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(caches)]
    assert got == [(tuple(w.shape), {"float32": torch.float32,
                                     "bfloat16": torch.bfloat16}[
                                         str(w.dtype)])
                   for w in jax.tree.leaves(want)]
    assert any(t.dtype == torch.float32 for t in tree_leaves(caches))


@pytest.mark.parametrize("arch", sorted(ARCHS_J))   # the reference's archs
def test_layer_configs_equal_the_reference(arch):
    """``moe_config``, ``ssm_config`` and ``rglru_config`` of every config
    (and with padded experts) field for field the reference's."""
    from repro.models import blocks as jb
    from repro_torch.models import blocks as tb
    for cfg, jcfg in ((ARCHS_T[arch], ARCHS_J[arch]),
                      (dataclasses.replace(ARCHS_T[arch],
                                           moe_pad_experts=True),
                       dataclasses.replace(ARCHS_J[arch],
                                           moe_pad_experts=True))):
        pairs = [(tb.ssm_config(cfg), jb.ssm_config(jcfg)),
                 (tb.rglru_config(cfg), jb.rglru_config(jcfg))]
        if cfg.moe is not None:
            pairs.append((tb.moe_config(cfg), jb.moe_config(jcfg)))
        for got, want in pairs:
            assert port_only_dict(got) == dataclasses.asdict(want)
            assert type(got).__name__ == type(want).__name__
