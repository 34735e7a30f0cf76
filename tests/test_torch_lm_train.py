"""The port's LM training stack against the reference on the CPU: the
loss, its gradients, the K5 branch rule, ``Trainer``, checkpoints across
packages, ``launch.train`` and ``examples.train_lm``.

Reduced configs (2 layers, d 256, f32) with the reference's own
parameters, converted with ``params_from_jax``; tokens are the port's
synthetic batches, passed to the reference as numpy.  Tolerances:
``softmax_cross_entropy`` 1e-6; losses 1e-5; gradients 1e-4 of each
leaf's largest; ``Trainer`` losses 1e-5 a step and parameters 2·lr a step
(Adam's step flips sign on a near-zero gradient when the two frameworks
round it differently).  Checkpoints cross packages bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.models.registry import get_model as j_get_model
from repro.nn.losses import softmax_cross_entropy as j_ce
from repro.train import checkpoint as j_ckpt
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer

from repro_torch.models.config import port_only_dict
from repro_torch.convert import params_from_jax
from repro_torch.data import frontend_batches, lm_batches
from repro_torch.models.registry import get_model
from repro_torch.nn import attention as t_attn
from repro_torch.nn.losses import softmax_cross_entropy
from repro_torch.nn.module import (cast_tree, param_bytes, param_count,
                                   tree_leaves, tree_map, tree_paths,
                                   tree_unflatten)
from repro_torch.train import checkpoint
from repro_torch.train.trainer import TrainConfig, Trainer

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ARCH = "qwen3-0.6b"
VLM = "llava-next-mistral-7b"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _models(arch, seed=0):
    jcfg, jmodel = j_get_model(arch, reduced=True)
    jp = jmodel.init(jax.random.PRNGKey(seed))
    cfg, model = get_model(arch, reduced=True)
    return cfg, model, params_from_jax(jp, device="cpu"), jmodel, jp


def _batch(cfg, B=2, S=32, seed=0):
    batch = next(lm_batches(cfg.vocab, B, S, seed=seed, device="cpu"))
    if cfg.family == "vlm":
        fe = next(frontend_batches(B, cfg.n_frontend_tokens, cfg.d_model,
                                   seed=seed, device="cpu"))
        batch["frontend_embeds"] = fe
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def qwen3():
    return _models(ARCH)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches(dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 300)) * 4).astype(np.float32)
    targets = rng.integers(0, 300, (2, 7), dtype=np.int32)
    jl = jnp.asarray(logits).astype(getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want = j_ce(jl, jnp.asarray(targets))
    got = softmax_cross_entropy(tl, torch.from_numpy(targets))
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_loss_matches_reference(arch):
    """The VLM backbone prepends 16 frontend tokens, which the loss slices
    off before the next-token targets."""
    cfg, model, tp, jmodel, jp = _models(arch)
    batch = _batch(cfg)
    want, jaux = jmodel.loss(jp, _to_jax(batch), remat=False)
    got, aux = model.loss(tp, batch, remat=False)
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                               atol=1e-5, rtol=1e-5)
    assert float(aux["moe_aux_loss"]) == 0.0


def _grads(model, tp, batch, remat):
    leaves = [x.detach().requires_grad_() for x in tree_leaves(tp)]
    loss, _ = model.loss(tree_unflatten(tp, leaves), batch, remat=remat)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_gradients_match_jax_value_and_grad(qwen3):
    cfg, model, tp, jmodel, jp = qwen3
    batch = _batch(cfg, seed=1)
    jb = _to_jax(batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat=False), has_aux=True)(jp)
    loss, grads = _grads(model, tp, batch, remat=False)
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-5, rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(_np(g) - w).max() <= 1e-4 * scale


def test_remat_changes_no_number(qwen3):
    """``torch.utils.checkpoint`` per super-block recomputes the same
    activations: loss and every gradient bit for bit."""
    cfg, model, tp, _, _ = qwen3
    batch = _batch(cfg, seed=2)
    l0, g0 = _grads(model, tp, batch, remat=False)
    l1, g1 = _grads(model, tp, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_forward_is_unchanged_by_unbinding_the_segments(qwen3):
    """The super-blocks are unbound once a leaf; the forward's numbers are
    those of indexing each leaf."""
    cfg, model, tp, _, _ = qwen3
    tokens = _batch(cfg, seed=3)["tokens"]
    x = model._embed_inputs(tp, tokens, None)
    for s in range(cfg.n_pattern):
        seg = tree_map(lambda t: t[s], tp["scan"])
        x, _ = model._super_apply(seg, x, False)
    want = model._head(tp, x)
    got, _ = model.forward(tp, tokens)
    assert torch.equal(got, want)


def test_training_cores_take_the_eager_branch(qwen3, monkeypatch):
    """K5 has no backward: with parameters that require grad the cores
    never reach ``flash_attention`` (the rule reads autograd's state, not
    the device), and q/k/v and their norms receive non-zero gradients.
    Without autograd the same cores go through K5's path."""
    cfg, model, tp, _, _ = qwen3
    batch = _batch(cfg, seed=4)
    calls = []
    real = t_attn.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(t_attn, "flash_attention", counted)
    _, grads = _grads(model, tp, batch, remat=False)
    assert calls == []
    named = dict(zip([p for p, _ in tree_paths(tp)], grads))
    for name in ("wq/kernel", "wk/kernel", "wv/kernel", "q_norm/scale",
                 "k_norm/scale"):
        g = named[f"scan/b0_attn/attn/{name}"]
        assert g.abs().amax(dim=tuple(range(1, g.dim()))).min() > 0
    with torch.no_grad():
        model.loss(tp, batch)
    assert len(calls) == cfg.n_layers
    leaf = tp["scan"]["b0_attn"]["attn"]["wq"]["kernel"].detach()
    assert t_attn.needs_autograd({"w": leaf.requires_grad_()}, tp["embed"][
        "embedding"])
    with torch.no_grad():
        assert not t_attn.needs_autograd({"w": leaf}, leaf)


def test_tree_helpers_match_the_reference(qwen3):
    from repro.nn import module as j_module
    _, _, tp, _, jp = qwen3
    assert [p for p, _ in tree_paths(tp)] == \
        [p for p, _ in j_module.tree_paths(jp)]
    assert param_count(tp) == j_module.param_count(jp)
    assert param_bytes(tp) == j_module.param_bytes(jp)
    half = cast_tree({"a": tp["embed"]["embedding"], "n": torch.arange(3)},
                     torch.bfloat16)
    assert half["a"].dtype == torch.bfloat16
    assert half["n"].dtype == torch.int64
    assert param_bytes(cast_tree(tp, torch.bfloat16)) == \
        j_module.param_bytes(j_module.cast_tree(jp, jnp.bfloat16))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def test_trainer_three_steps_match_the_reference(qwen3):
    cfg, _, tp, _, jp = qwen3
    lr = 1e-3
    data = lm_batches(cfg.vocab, 2, 32, seed=5, device="cpu")
    batches = [next(data) for _ in range(3)]
    jtr = JTrainer(cfg, JTrainConfig(batch=2, steps=3, lr=lr, warmup=1,
                                     log_every=1))
    jparams, _, jhist = jtr.run(
        iter([{k: np.asarray(v) for k, v in b.items()} for b in batches]),
        params=jp, opt_state=jtr.optimizer.init(jp))
    tr = Trainer(cfg, TrainConfig(batch=2, steps=3, lr=lr, warmup=1,
                                  log_every=1), device="cpu")
    params, opt_state, hist = tr.run(iter(batches), params=tp)
    assert [h["step"] for h in hist] == [0, 1, 2]
    for h, jh in zip(hist, jhist):
        for key in ("loss", "ce", "moe_aux_loss"):
            assert abs(h[key] - jh[key]) <= 1e-5 * max(1.0, abs(jh[key]))
        assert h["wall_s"] >= 0
    assert int(opt_state.step) == 3
    for got, want in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert np.abs(_np(got) - np.asarray(want)).max() <= 2 * lr * 3


def test_trainer_loss_decreases_on_the_cpu():
    cfg, _ = get_model(ARCH, reduced=True)
    trainer = Trainer(cfg, TrainConfig(batch=4, steps=25, lr=1e-3,
                                       log_every=5), device="cpu")
    _, _, history = trainer.run(lm_batches(cfg.vocab, 4, 64, device="cpu"))
    assert history[-1]["loss"] < history[0]["loss"] - 0.2
    assert [h["step"] for h in history] == [0, 5, 10, 15, 20, 24]


def test_trainer_checkpoints_every_ckpt_every(tmp_path, monkeypatch):
    cfg, _ = get_model(ARCH, reduced=True)
    path = str(tmp_path / "ck")
    seen = []
    orig = checkpoint.save

    def spy(p, tree, *, step=None):
        seen.append(step)
        orig(p, tree, step=step)

    monkeypatch.setattr(checkpoint, "save", spy)
    trainer = Trainer(cfg, TrainConfig(batch=1, steps=5, ckpt_dir=path,
                                       ckpt_every=2), device="cpu")
    params, _, _ = trainer.run(lm_batches(cfg.vocab, 1, 16, device="cpu"))
    assert seen == [2, 4, 5] and checkpoint.latest_step(path) == 5
    back = checkpoint.restore(path, {"params": params}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back["params"]), tree_leaves(params)))


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _bf16_tree():
    jcfg = dataclasses.replace(j_get_model(ARCH, reduced=True)[0],
                               dtype="bfloat16")
    from repro.models.transformer import DecoderModel as JDecoder
    jp = JDecoder(jcfg).init(jax.random.PRNGKey(4))
    return {"params": jp, "extra": {"n": jnp.arange(6, dtype=jnp.int32)
                                    .reshape(2, 3),
                                    "s": jnp.zeros((), jnp.float32) + 1.5}}


def _assert_same_bits(torch_tree, jax_tree):
    from repro.nn.module import tree_paths as j_paths
    flat_t = dict(tree_paths(torch_tree))
    flat_j = dict(j_paths(jax_tree))
    assert sorted(flat_t) == sorted(flat_j)
    for k, w in flat_j.items():
        t = flat_t[k]
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert t.numpy().dtype == w.dtype
            np.testing.assert_array_equal(t.numpy(), w)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jtree = _bf16_tree()
    path = str(tmp_path / "ref")
    j_ckpt.save(path, jtree, step=7)
    like = params_from_jax(jtree, device="cpu")
    got = checkpoint.restore(path, like, device="cpu")
    _assert_same_bits(got, jtree)
    assert checkpoint.latest_step(path) == 7


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jtree = _bf16_tree()
    ttree = params_from_jax(jtree, device="cpu")
    tpath, jpath = str(tmp_path / "port"), str(tmp_path / "ref")
    checkpoint.save(tpath, ttree, step=3)
    j_ckpt.save(jpath, jtree, step=3)
    back = j_ckpt.restore(tpath, jtree)
    _assert_same_bits(ttree, back)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
    with open(os.path.join(tpath, "manifest.json")) as f1, \
            open(os.path.join(jpath, "manifest.json")) as f2:
        m1, m2 = f1.read(), f2.read()
    assert m1 == m2 and json.loads(m1)["dtypes"]["params/embed/embedding"] \
        == "bfloat16"
    assert j_ckpt.latest_step(tpath) == 3


# ---------------------------------------------------------------------------
# the launcher, the example and the device rule
# ---------------------------------------------------------------------------

def test_launch_train_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch
    path = str(tmp_path / "ck")
    assert launch.main(["--device", "cpu", "--steps", "12", "--batch", "2",
                        "--seq", "32", "--lr", "1e-3", "--ckpt", path]) == 0
    out = capsys.readouterr().out
    assert "training qwen3-0.6b (reduced=True) on cpu" in out
    assert checkpoint.latest_step(path) == 12


def test_launch_train_feeds_the_vlm_frontend(capsys):
    from repro_torch.launch import train as launch
    assert launch.main(["--arch", VLM, "--device", "cpu", "--steps", "8",
                        "--batch", "2", "--seq", "16", "--lr",
                        "1e-3"]) == 0
    assert "loss" in capsys.readouterr().out


def test_example_restores_its_checkpoint(tmp_path, monkeypatch):
    from repro_torch.examples import train_lm
    small = dataclasses.replace(
        train_lm.hundred_m_config(), n_layers=2, n_pattern=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512)
    monkeypatch.setattr(train_lm, "hundred_m_config", lambda: small)
    out = train_lm.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt", str(tmp_path / "ck")])
    assert out["loss"] == out["restored_loss"]
    assert checkpoint.latest_step(out["ckpt_dir"]) == 3
    assert len(out["history"]) == 2   # steps 0 and 2 (log_every 20)


def test_hundred_m_config_equals_the_reference():
    import importlib.util
    from repro_torch.examples import train_lm
    spec = importlib.util.spec_from_file_location(
        "ref_train_lm", os.path.join(os.path.dirname(__file__), "..",
                                     "examples", "train_lm.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert port_only_dict(train_lm.hundred_m_config()) == \
        dataclasses.asdict(ref.hundred_m_config())


def test_training_entry_points_refuse_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch
    cfg, _ = get_model(ARCH, reduced=True)
    for call in (lambda: Trainer(cfg, TrainConfig()),
                 lambda: launch.main(["--steps", "1"]),
                 lambda: train_lm.main(["--steps", "1"]),
                 lambda: next(lm_batches(cfg.vocab, 1, 8)),
                 lambda: checkpoint.restore("nowhere", {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
