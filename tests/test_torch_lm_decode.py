"""The port's LM decode path against the reference on the CPU.

``decode_attention`` on both cache-update branches (the row write and the
masked form), with and without a sliding window and the window gather, at
a scalar and a ``(1,)`` index; cross-attention; ``DecoderModel.decode_step``
over 16 tokens for reduced qwen3-0.6b (4/4 heads), a GQA variant with a
sliding-window pattern and the long-context window.  Parameters are the
reference's own, converted with ``params_from_jax``; inputs come from
numpy with a seed.  The reference's decode step runs under ``jax.jit``.

Tolerances: f32 outputs 1e-5 (the two frameworks sum in other orders); a
written cache row 1e-6; every other cache row bit for bit; logits over an
f32 cache 1e-5, over the default bf16 cache 2e-2 (a bf16 row rounds the
projection once more); decode against the full-sequence forward 2e-2, the
reference's own ``test_decode_matches_forward_end_to_end``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.models.registry import get_model as j_get_model
from repro.models.transformer import DecoderModel as JDecoder
from repro.nn import attention as j_attn

from repro_torch.convert import params_from_jax
from repro_torch.models.registry import (SHAPE_IDS, get_model, long_ctx,
                                         text_len)
from repro_torch.models.transformer import DecoderModel
from repro_torch.nn import attention as t_attn

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

ACFG = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True)
S_MAX = 12


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _attn_pair(seed=0, **over):
    jcfg = j_attn.AttentionConfig(**ACFG, **over)
    tcfg = t_attn.AttentionConfig(**ACFG, **over)
    jp = j_attn.attention_init(jax.random.PRNGKey(seed), jcfg)
    for name in ("q_norm", "k_norm"):
        jp[name]["scale"] = jnp.asarray(1.0 + 0.1 * _rand((16,), seed + 7))
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


# ---------------------------------------------------------------------------
# decode_attention and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vector_index", [False, True])
@pytest.mark.parametrize("window,gather", [(None, False), (4, False),
                                           (4, True)])
@pytest.mark.parametrize("masked", [False, True])
def test_decode_attention_matches_reference(masked, window, gather,
                                            vector_index):
    over = dict(masked_cache_update=masked, sliding_window=window,
                windowed_decode_gather=gather)
    jcfg, tcfg, jp, tp = _attn_pair(1, **over)
    x = _rand((1, 1, 64), 2)
    ck, cv = _rand((1, S_MAX, 2, 16), 3), _rand((1, S_MAX, 2, 16), 4)
    for i in (0, 7, S_MAX - 1):
        j_index = jnp.asarray([i] if vector_index else i, jnp.int32)
        t_index = torch.tensor([i]) if vector_index else i
        cache = {"k": torch.from_numpy(ck.copy()),
                 "v": torch.from_numpy(cv.copy())}
        out, new = t_attn.decode_attention(tp, tcfg, torch.from_numpy(x),
                                           cache, t_index)
        j_out, j_new = j_attn.decode_attention(
            jp, jcfg, jnp.asarray(x),
            {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, j_index)
        np.testing.assert_allclose(_np(out), _np(j_out), atol=1e-5,
                                   rtol=1e-5)
        assert new is cache       # written in place
        for name, before in (("k", ck), ("v", cv)):
            got, want = new[name].numpy(), np.asarray(j_new[name])
            assert new[name].dtype == torch.float32
            assert got.shape == want.shape == before.shape
            keep = np.arange(S_MAX) != i
            np.testing.assert_array_equal(got[:, keep], before[:, keep])
            np.testing.assert_array_equal(got[:, keep], want[:, keep])
            np.testing.assert_allclose(got[:, i], want[:, i], atol=1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_out_of_range_index_follows_each_update_branch(masked):
    """At index S_max the row write clamps to the last row (the reference's
    dynamic update slice) and the masked form writes nothing (its
    where())."""
    jcfg, tcfg, jp, tp = _attn_pair(2, masked_cache_update=masked)
    x = _rand((1, 1, 64), 5)
    ck, cv = _rand((1, S_MAX, 2, 16), 6), _rand((1, S_MAX, 2, 16), 7)
    cache = {"k": torch.from_numpy(ck.copy()),
             "v": torch.from_numpy(cv.copy())}
    out, new = t_attn.decode_attention(tp, tcfg, torch.from_numpy(x), cache,
                                       torch.tensor(S_MAX))
    j_out, j_new = j_attn.decode_attention(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.int32(S_MAX))
    np.testing.assert_allclose(_np(out), _np(j_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(new["k"].numpy(), np.asarray(j_new["k"]),
                               atol=1e-6, rtol=1e-6)
    same = np.array_equal(new["k"].numpy(), ck)
    assert same == masked


def test_init_kv_cache_is_bf16_by_default():
    _, tcfg, _, _ = _attn_pair(0)
    jcfg = j_attn.AttentionConfig(**ACFG)
    cache = t_attn.init_kv_cache(tcfg, 2, 8, device="cpu")
    ref = j_attn.init_kv_cache(jcfg, 2, 8)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        assert ref[name].dtype == jnp.bfloat16
        assert tuple(cache[name].shape) == ref[name].shape == (2, 8, 2, 16)
        assert not cache[name].any()


def test_cross_attention_and_cross_kv():
    jcfg, tcfg, jp, tp = _attn_pair(3)
    x, src = _rand((2, 5, 64), 8), _rand((2, 9, 64), 9)
    k, v = t_attn.cross_kv(tp, tcfg, torch.from_numpy(src))
    jk, jv = j_attn.cross_kv(jp, jcfg, jnp.asarray(src))
    np.testing.assert_allclose(_np(k), _np(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(v), _np(jv), atol=1e-5, rtol=1e-5)
    want = j_attn.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(src))
    got = t_attn.cross_attention(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(src))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # the decode path's form: precomputed k/v
    got_kv = t_attn.cross_attention(tp, tcfg, torch.from_numpy(x), k=k, v=v)
    np.testing.assert_array_equal(_np(got_kv), _np(got))


# ---------------------------------------------------------------------------
# decode_step over 16 tokens
# ---------------------------------------------------------------------------

def _qwen3():
    return j_get_model("qwen3-0.6b", reduced=True)[0]


def _minitron():
    cfg = j_get_model("minitron-8b", reduced=True)[0]
    assert (cfg.norm, cfg.mlp, cfg.qkv_bias) == ("layernorm", "relu2", False)
    return cfg


MODELS = {
    "qwen3-0.6b": (_qwen3, False),
    # GQA (4 query heads over 2 KV heads) with swa blocks, their window
    # gathered from the cache
    "swa-gqa": (lambda: dataclasses.replace(
        _qwen3(), pattern=("attn", "swa"), n_pattern=1, sliding_window=4,
        n_kv_heads=2, windowed_decode_gather=True), False),
    # the long-context variant: every attn block windowed
    "long-ctx": (lambda: dataclasses.replace(
        _qwen3(), long_context_window=6, masked_cache_update=False), True),
    # minitron-shaped long context (LayerNorm, squared ReLU, no QKV bias,
    # untied head), its window scored over the whole cache and gathered
    "minitron-long-ctx": (lambda: dataclasses.replace(
        _minitron(), long_context_window=6), True),
    "minitron-long-ctx-gather": (lambda: dataclasses.replace(
        _minitron(), long_context_window=6, windowed_decode_gather=True),
        True),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def decoded(request):
    """(name, port logits over an f32 cache, over a bf16 cache, the
    reference's over each, the port's forward, the two f32 caches)."""
    make, lctx = MODELS[request.param]
    jcfg = make()
    jmodel = JDecoder(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(2))
    model = DecoderModel(jcfg)
    tp = params_from_jax(jp, device="cpu")
    B, S = 1, 16
    tokens = np.random.default_rng(3).integers(3, jcfg.vocab, (B, S),
                                               dtype=np.int32)
    step = jax.jit(jmodel.decode_step, static_argnames="long_ctx")
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jc = jmodel.init_cache(B, S, jdt)
        tc = model.init_cache(B, S, tdt, device="cpu")
        index = torch.zeros((), dtype=torch.int32)
        js, ts = [], []
        for t in range(S):
            lg, jc = step(jp, jnp.asarray(tokens[:, t:t + 1]), jc,
                          jnp.int32(t), long_ctx=lctx)
            tl, tc = model.decode_step(tp, torch.from_numpy(
                tokens[:, t:t + 1]), tc, index, long_ctx=lctx)
            index += 1
            js.append(np.asarray(lg, np.float32))
            ts.append(_np(tl))
        out[name] = (np.concatenate(ts, 1), np.concatenate(js, 1), tc, jc)
    full, _ = model.forward(tp, torch.from_numpy(tokens), long_ctx=lctx)
    return request.param, out, _np(full)


def test_decode_step_matches_reference_over_an_f32_cache(decoded):
    _, out, _ = decoded
    got, want, tc, jc = out["f32"]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # the cache crosses packages: the same tree, shapes and dtypes
    flat_j = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(flat_j) == sum(len(v) for v in tc["scan"].values())
    for path, leaf in flat_j:
        t = tc
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(leaf), atol=1e-5,
                                   rtol=1e-5)


def test_decode_step_matches_reference_over_the_bf16_cache(decoded):
    _, out, _ = decoded
    got, want, tc, _ = out["bf16"]
    assert tc["scan"]["b0_attn"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_decode_matches_the_ports_forward(decoded):
    _, out, full = decoded
    np.testing.assert_allclose(out["f32"][0], full, atol=2e-2, rtol=2e-2)


def test_decode_step_needs_no_autograd():
    cfg, model = get_model("qwen3-0.6b", reduced=True)
    tp = model.init(torch.Generator().manual_seed(0), device="cpu")
    for t in (tp["embed"]["embedding"], tp["scan"]["b0_attn"]["attn"]["wq"]
              ["kernel"]):
        t.requires_grad_()
    caches = model.init_cache(1, 4, device="cpu")
    logits, caches = model.decode_step(tp, torch.tensor([[5]]), caches, 0)
    assert not logits.requires_grad and logits.shape == (1, 1, cfg.vocab)
    assert caches["scan"]["b0_attn"]["k"][:, :, 0].any()


def test_init_cache_stacks_as_the_reference():
    jcfg = _qwen3()
    want = JDecoder(jcfg).init_cache(2, 8)
    got = DecoderModel(jcfg).init_cache(2, 8, device="cpu")
    assert sorted(got) == sorted(want) == ["scan"]
    for key, leaf in want["scan"]["b0_attn"].items():
        assert tuple(got["scan"]["b0_attn"][key].shape) == leaf.shape == (
            jcfg.n_pattern, 2, 8, jcfg.n_kv_heads, jcfg.head_dim)
        assert got["scan"]["b0_attn"][key].dtype == torch.bfloat16


def test_shape_helpers_equal_the_reference():
    from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES
    from repro.models import registry as j_reg
    from repro_torch.configs import ARCHS, SHAPES
    assert SHAPE_IDS == j_reg.SHAPE_IDS
    for sid in SHAPE_IDS:
        assert long_ctx(sid) == j_reg.long_ctx(sid)
        for arch in sorted(J_ARCHS):
            assert text_len(ARCHS[arch], SHAPES[sid]) == j_reg.text_len(
                J_ARCHS[arch], J_SHAPES[sid])
