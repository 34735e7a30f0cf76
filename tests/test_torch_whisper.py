"""The port's Whisper encoder–decoder against the reference on the CPU.

Reduced whisper-medium (2 encoder + 2 decoder layers, d 256, 4/4 heads,
head_dim 32, vocab 1024, 16 frames, f32) with the reference's own
``WhisperModel.init`` parameters, converted with ``params_from_jax``;
frames and tokens from numpy with a seed.  Tolerances: the sinusoidal
table 1e-6; ``encode``, ``decode_full``, ``forward``, the loss and the
decode step's logits 1e-5 (the two frameworks sum in other orders); each
gradient leaf 1e-5 of its largest (the K-projection biases' gradients
are zero in exact arithmetic, rounding noise of 1e-9 in both packages:
those are held below 1e-5 of the largest gradient of all leaves); the
f32 self-KV cache 1e-5 of its largest; the bf16 cross cache, rounded from
f32 values that differ by 1e-6, within one bf16 step (rtol 2^-7) plus
1e-5, and the decode steps then read the reference's cross cache.
Checkpoints cross packages bit for bit.  The attention cores take K5's
plain version here (non-causal in the encoder, at 16 frames and at
ragged lengths), as they take K5 on the card.
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
from repro.nn.rotary import sinusoidal_positions as j_sinusoidal
from repro.train import checkpoint as j_ckpt

from repro_torch.convert import params_from_jax
from repro_torch.data import frontend_batches, lm_batches
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.registry import build_model, get_model
from repro_torch.models.whisper import WhisperModel
from repro_torch.nn import attention as t_attn
from repro_torch.nn.module import (tree_leaves, tree_map, tree_paths,
                                   tree_unflatten)
from repro_torch.nn.rotary import sinusoidal_positions
from repro_torch.train import checkpoint
from repro_torch.train.trainer import TrainConfig, Trainer

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ARCH = "whisper-medium"
TOL = 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, port model, port params, ref model, ref params)."""
    _, jmodel = j_get_model(ARCH, reduced=True)
    jp = jmodel.init(jax.random.PRNGKey(0))
    cfg, model = get_model(ARCH, reduced=True)
    return cfg, model, params_from_jax(jp, device="cpu"), jmodel, jp


def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
              * 0.02).astype(np.float32)
    tokens = rng.integers(3, cfg.vocab, (B, S), dtype=np.int32)
    return frames, tokens


# ---------------------------------------------------------------------------
# the config and the positions
# ---------------------------------------------------------------------------

def test_reduced_config_is_two_plus_two_layers(reduced):
    cfg, model, tp, _, jp = reduced
    assert isinstance(model, WhisperModel)
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.n_frontend_tokens,
            cfg.d_model, cfg.dtype) == (2, 2, 16, 256, "float32")
    assert [p for p, _ in tree_paths(tp)] == \
        ["/".join(str(k.key) for k in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert tp["enc_scan"]["attn"]["wq"]["kernel"].shape[0] == 2
    assert tp["dec_pos"]["embedding"].shape == (448, cfg.d_model)


@pytest.mark.parametrize("shape", [(16, 256), (1500, 1024), (448, 64),
                                   (7, 3), (5, 2)])
def test_sinusoidal_positions_match(shape):
    """Whisper-medium's own table (1,500 x 1,024) included: the power is
    rounded once from float64, as XLA's correctly rounded power."""
    got = sinusoidal_positions(*shape)
    want = np.asarray(j_sinusoidal(*shape))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_init_draws_the_reference_tree_shapes():
    cfg, model = get_model(ARCH, reduced=True)
    tp = model.init(torch.Generator().manual_seed(0), device="cpu")
    _, jmodel = j_get_model(ARCH, reduced=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = {"/".join(str(k.key) for k in path): (tuple(s.shape), s.dtype)
            for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in tree_paths(tp)}
    assert got == {k: (s, str(d)) for k, (s, d) in want.items()}
    assert float(tp["enc_norm"]["scale"].sum()) == cfg.d_model


# ---------------------------------------------------------------------------
# encode, decode_full, forward, loss and its gradients
# ---------------------------------------------------------------------------

def test_encode_matches(reduced):
    """On the CPU the non-causal cores take K5's plain version, which
    launches nothing."""
    cfg, model, tp, jmodel, jp = reduced
    frames, _ = _inputs(cfg)
    before = flash_attention.launches
    got = model.encode(tp, torch.from_numpy(frames))
    assert flash_attention.launches == before
    want = jmodel.encode(jp, jnp.asarray(frames))
    assert got.shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S", [12, 1])
def test_decode_full_matches(reduced, S):
    cfg, model, tp, jmodel, jp = reduced
    frames, tokens = _inputs(cfg, S=S, seed=1)
    enc = jmodel.encode(jp, jnp.asarray(frames))
    got, aux = model.decode_full(tp, torch.from_numpy(tokens),
                                 torch.from_numpy(np.array(enc)))
    want, _ = jmodel.decode_full(jp, jnp.asarray(tokens), enc)
    assert aux == {} and got.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def test_forward_matches(reduced):
    cfg, model, tp, jmodel, jp = reduced
    frames, tokens = _inputs(cfg, seed=2)
    got, _ = model.forward(tp, torch.from_numpy(tokens),
                           frontend_embeds=torch.from_numpy(frames))
    want, _ = jmodel.forward(jp, jnp.asarray(tokens),
                             frontend_embeds=jnp.asarray(frames))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def test_decoder_positions_wrap_at_448(reduced):
    """Past the 448-row table the positions wrap, as in the reference."""
    cfg, model, tp, jmodel, jp = reduced
    got = model._dec_positions(tp, 446, 5, 2)
    want = jmodel._dec_positions(jp, 446, 5, 2)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got[1, 2]),
                                  _np(tp["dec_pos"]["embedding"][0]))


def _grads(model, tp, batch, remat):
    leaves = [x.detach().requires_grad_() for x in tree_leaves(tp)]
    loss, aux = model.loss(tree_unflatten(tp, leaves), batch, remat=remat)
    return loss.detach(), aux, torch.autograd.grad(loss, leaves)


def test_loss_and_gradients_match_jax_value_and_grad(reduced):
    cfg, model, tp, jmodel, jp = reduced
    frames, tokens = _inputs(cfg, seed=3)
    jb = {"tokens": jnp.asarray(tokens),
          "frontend_embeds": jnp.asarray(frames)}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, remat=False), has_aux=True)(jp)
    loss, aux, grads = _grads(model, tp, {
        "tokens": torch.from_numpy(tokens),
        "frontend_embeds": torch.from_numpy(frames)}, remat=False)
    np.testing.assert_allclose(float(loss), float(jl), atol=TOL, rtol=TOL)
    assert set(aux) == {"ce"} and float(aux["ce"].detach()) == float(loss)
    want = [np.asarray(w) for w in jax.tree.leaves(jg)]
    floor = TOL * max(float(np.abs(w).max()) for w in want)
    names = [p for p, _ in tree_paths(tp)]
    for name, g, w in zip(names, grads, want):
        assert g.shape == w.shape, name
        if name.endswith("wk/bias"):
            # a key bias shifts a query's every score alike: its exact
            # gradient is zero, and both packages give rounding noise
            assert max(np.abs(_np(g)).max(), np.abs(w).max()) <= floor, name
            continue
        scale = float(np.abs(w).max())
        assert np.abs(_np(g) - w).max() <= TOL * scale, name


def test_remat_changes_no_number(reduced):
    """``torch.utils.checkpoint`` a decoder block recomputes the same
    activations: the loss and every gradient bit for bit."""
    cfg, model, tp, _, _ = reduced
    frames, tokens = _inputs(cfg, seed=4)
    batch = {"tokens": torch.from_numpy(tokens),
             "frontend_embeds": torch.from_numpy(frames)}
    l0, _, g0 = _grads(model, tp, batch, remat=False)
    l1, _, g1 = _grads(model, tp, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# the K5 branch rule on the Whisper cores
# ---------------------------------------------------------------------------

def test_cores_take_k5_without_autograd_and_eager_with_it(reduced,
                                                          monkeypatch):
    """The encoder's non-causal cores and the decoder's causal ones reach
    ``flash_attention`` (at 16 frames and at a ragged 200-token decoder
    length, blocks that tile S), cross-attention never; a loss under
    autograd reaches it no time."""
    cfg, model, tp, _, _ = reduced
    calls = []
    real = t_attn.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[2], kw["causal"], kw["block_q"],
                      kw["block_k"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(t_attn, "flash_attention", counted)
    frames, tokens = _inputs(cfg, S=200, seed=5)
    batch = {"tokens": torch.from_numpy(tokens),
             "frontend_embeds": torch.from_numpy(frames)}
    with torch.no_grad():
        model.loss(tp, batch)
    assert calls == [(16, False, 16, 16)] * 2 + [(200, True, 200, 200)] * 2
    calls.clear()
    _grads(model, tp, batch, remat=True)
    assert calls == []


# ---------------------------------------------------------------------------
# the cache and the decode step
# ---------------------------------------------------------------------------

def test_cache_prefill_and_four_decode_steps_match(reduced):
    cfg, model, tp, jmodel, jp = reduced
    frames, tokens = _inputs(cfg, S=4, seed=6)
    jenc = jmodel.encode(jp, jnp.asarray(frames))
    tenc = model.encode(tp, torch.from_numpy(frames))
    jc = jmodel.prefill_cross_cache(
        jp, jenc, jmodel.init_cache(2, 8, dtype=jnp.float32))
    tc = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
    zeros = jmodel.init_cache(2, 8, dtype=jnp.float32)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), zeros) == \
        tree_map(lambda t: (tuple(t.shape),
                            str(t.dtype).removeprefix("torch.")), tc)
    self_k = tc["self"]["k"]
    tc = model.prefill_cross_cache(tp, tenc, tc)
    for name in ("k", "v"):
        assert tc["cross"][name].dtype == torch.bfloat16
        np.testing.assert_allclose(
            _np(tc["cross"][name]),
            np.asarray(jc["cross"][name].astype(jnp.float32)),
            rtol=2 ** -7, atol=TOL)
    # the decode steps read the reference's bf16 cross cache, bit for bit:
    # an entry one bf16 step apart moves a logit by about 1e-5
    tc["cross"] = params_from_jax(jc["cross"], device="cpu")
    for i in range(4):
        jl, jc = jmodel.decode_step(jp, jnp.asarray(tokens[:, i:i + 1]), jc,
                                    jnp.asarray(i))
        tl, tc = model.decode_step(tp, torch.from_numpy(tokens[:, i:i + 1]),
                                   tc, torch.tensor(i))
        assert tl.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=TOL)
    assert tc["self"]["k"] is self_k      # written in place
    for name in ("k", "v"):
        want = np.asarray(jc["self"][name])
        got = _np(tc["self"][name])
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
        assert not got[:, :, 4:].any()    # rows past the index untouched


def test_decode_matches_the_teacher_forced_decoder(reduced):
    """16 decode steps against ``decode_full`` on the same encoder output
    at the reference's decode-against-forward tolerance (2e-2): the cross
    cache is bf16."""
    cfg, model, tp, _, _ = reduced
    frames, tokens = _inputs(cfg, B=1, S=16, seed=7)
    enc = model.encode(tp, torch.from_numpy(frames))
    full, _ = model.decode_full(tp, torch.from_numpy(tokens), enc)
    c = model.prefill_cross_cache(
        tp, enc, model.init_cache(1, 16, torch.float32, device="cpu"))
    outs = []
    for t in range(16):
        lg, c = model.decode_step(tp, torch.from_numpy(tokens[:, t:t + 1]),
                                  c, t)
        outs.append(lg)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full),
                               atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# checkpoints, the trainer and the launcher
# ---------------------------------------------------------------------------

def _bf16_tree():
    jcfg, _ = j_get_model(ARCH, reduced=True)
    from repro.models.whisper import WhisperModel as JWhisper
    jp = JWhisper(dataclasses.replace(jcfg, dtype="bfloat16")).init(
        jax.random.PRNGKey(4))
    return {"params": jp}


def _assert_same_bits(torch_tree, jax_tree):
    from repro.nn.module import tree_paths as j_paths
    flat_t = dict(tree_paths(torch_tree))
    flat_j = dict(j_paths(jax_tree))
    assert sorted(flat_t) == sorted(flat_j)
    for k, w in flat_j.items():
        t, w = flat_t[k], np.asarray(w)
        assert t.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, k
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      w.view(np.int16))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jtree = _bf16_tree()
    path = str(tmp_path / "ref")
    j_ckpt.save(path, jtree, step=5)
    got = checkpoint.restore(path, params_from_jax(jtree, device="cpu"),
                             device="cpu")
    _assert_same_bits(got, jtree)
    assert checkpoint.latest_step(path) == 5


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jtree = _bf16_tree()
    ttree = params_from_jax(jtree, device="cpu")
    tpath, jpath = str(tmp_path / "port"), str(tmp_path / "ref")
    checkpoint.save(tpath, ttree, step=2)
    j_ckpt.save(jpath, jtree, step=2)
    _assert_same_bits(ttree, j_ckpt.restore(tpath, jtree))
    with open(os.path.join(tpath, "manifest.json")) as f1, \
            open(os.path.join(jpath, "manifest.json")) as f2:
        m1, m2 = f1.read(), f2.read()
    assert m1 == m2
    assert json.loads(m1)["dtypes"]["params/enc_scan/attn/wq/kernel"] == \
        "bfloat16"


def test_trainer_steps_and_checkpoints_a_whisper_tree(tmp_path):
    cfg, _ = get_model(ARCH, reduced=True)
    path = str(tmp_path / "ck")
    trainer = Trainer(cfg, TrainConfig(batch=2, steps=3, lr=1e-3, warmup=1,
                                       log_every=1, ckpt_dir=path),
                      device="cpu")
    assert isinstance(trainer.model, WhisperModel)
    fronts = frontend_batches(2, cfg.n_frontend_tokens, cfg.d_model,
                              device="cpu")
    toks = lm_batches(cfg.vocab, 2, 16, device="cpu")
    data = ({"tokens": next(toks)["tokens"], "frontend_embeds": next(fronts)}
            for _ in range(3))
    params, opt_state, hist = trainer.run(data)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert set(hist[0]) == {"loss", "ce", "step", "wall_s"}
    assert int(opt_state.step) == 3
    back = checkpoint.restore(path, {"params": params}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back["params"]), tree_leaves(params)))


def test_launch_train_on_the_cpu(capsys):
    from repro_torch.launch import train as launch
    assert launch.main(["--arch", ARCH, "--device", "cpu", "--steps", "8",
                        "--batch", "2", "--seq", "16", "--lr",
                        "1e-3"]) == 0
    out = capsys.readouterr().out
    assert "training whisper-medium (reduced=True) on cpu" in out


# ---------------------------------------------------------------------------
# the registry, the split launcher and the device rule
# ---------------------------------------------------------------------------

def test_full_width_builds_without_drawing():
    from repro_torch.configs import ARCHS
    model = build_model(ARCHS[ARCH])
    assert isinstance(model, WhisperModel) and model.cfg is ARCHS[ARCH]
    # the reference's analytic count leaves out cross-attention (and the
    # biases, norms and position table): 657 M of the tree's 759 M
    assert model.cfg.param_count() == 657_089_536


def test_split_entry_points_refuse_the_audio_family():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="whisper enc/dec split example"):
        serve.build_split(ARCH, reduced=True, edge_segments=1,
                          codec_name="uint8", batch=1, seq=8, device="cpu")
    with pytest.raises(SystemExit, match="whisper enc/dec split example"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--seq", "8"])


def test_init_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg, model = get_model(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 4)

