"""The port's attention stack against the reference on the CPU: K5's plain
version against the reference's Pallas ``flash_attention`` (interpret
mode; GQA K/V and transposed views on the repeated K/V), the wrapper's
checks and copy rule, an emulation of K5's tensor-core arithmetic,
``attention()`` on each of its branches, and the layers under it.

Inputs come from numpy with a seed and go unchanged to both packages;
parameters are the reference's own init, converted with
``params_from_jax``.  Tolerances: the Pallas comparison keeps the
reference test's own (f32 2e-4; bf16 3e-2, compared in f32); the
tensor-core emulation 1e-2, chip_smoke's bf16 ``ATTN_TOL`` for the card;
``attention()`` 1e-5 in f32 (the two frameworks sum in other orders);
rope and the norms 1e-6; the MLPs 1e-5.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ops import causal_attention as j_causal
from repro.models.blocks import attn_config as j_attn_config
from repro.nn import attention as j_attn
from repro.nn import layers as j_layers
from repro.nn.rotary import apply_rope as j_apply_rope
from repro.nn.module import KeyGen

from repro_torch.models.config import port_only_dict
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import (_addressable,
                                                 flash_attention,
                                                 tensor_core_route)
from repro_torch.kernels.ops import causal_attention
from repro_torch.kernels.ref import attention_ref
from repro_torch.models.blocks import attn_config, mla_config
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers
from repro_torch.nn.rotary import apply_rope

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# K5's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 64)])
def test_flash_plain_matches_pallas(s, window, blocks):
    bq, bk = blocks
    q, k, v = (_rand((1, 2, s, 32), s + i) for i in range(3))
    before = flash_attention.launches
    got = flash_attention(_t(q), _t(k), _t(v), causal=True,
                          sliding_window=window, block_q=bq, block_k=bk)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, sliding_window=window, block_q=bq,
                   block_k=bk, interpret=True)
    assert flash_attention.launches == before      # CPU: no kernel launch
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("s,blocks", [(100, (128, 128)), (192, (64, 64)),
                                      (200, (200, 200))])
@pytest.mark.parametrize("window", [None, 48])
def test_flash_plain_non_causal_ragged_matches_pallas(s, blocks, window):
    """``causal=False`` (Whisper's encoder) at lengths 128 does not tile,
    each with blocks that tile it, as ``nn.attention.flash_blocks`` picks
    them."""
    bq, bk = blocks
    q, k, v = (_rand((1, 2, s, 32), 3 * s + i) for i in range(3))
    got = flash_attention(_t(q), _t(k), _t(v), causal=False,
                          sliding_window=window, block_q=bq, block_k=bk)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, sliding_window=window, block_q=bq,
                   block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_dtypes_match_pallas(dtype):
    q, k, v = (_rand((1, 2, 128, 32), 7 + i) for i in range(3))
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = causal_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), block_q=64,
                           block_k=64)
    want = j_causal(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                    block_q=64, block_k=64, interpret=True)
    assert got.dtype == tdt
    tol = 2e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 2, 64, 32))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x[..., :12], x[..., :12], x[..., :12])
    with pytest.raises(ValueError, match="not tiled"):
        flash_attention(x[:, :, :48], x[:, :, :48], x[:, :, :48],
                        block_q=32)
    with pytest.raises(ValueError, match="sliding_window"):
        flash_attention(x, x, x, sliding_window=0)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(x, x[:, :1], x)


@pytest.mark.parametrize("h_kv", [1, 2, 4])
@pytest.mark.parametrize("layout", ["bhsd", "bshd-view"])
def test_flash_gqa_and_views_match_pallas(h_kv, layout):
    """K/V with fewer heads, and (B, H, S, D) views of (B, S, H, D)
    tensors, against the Pallas kernel on the repeated K/V."""
    S, D, H = 128, 32, 4
    shapes = [(2, H, S, D), (2, h_kv, S, D), (2, h_kv, S, D)]
    q, k, v = (_rand(sh, 40 + i) for i, sh in enumerate(shapes))
    if layout == "bhsd":
        tq, tk, tv = _t(q), _t(k), _t(v)
    else:
        tq, tk, tv = (_t(a.transpose(0, 2, 1, 3).copy()).transpose(1, 2)
                      for a in (q, k, v))
        assert not tq.is_contiguous()
    before = flash_attention.copies
    got = flash_attention(tq, tk, tv, causal=True, sliding_window=48,
                          block_q=64, block_k=64)
    rep = H // h_kv
    want = j_flash(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=1)),
                   jnp.asarray(np.repeat(v, rep, axis=1)), causal=True,
                   sliding_window=48, block_q=64, block_k=64, interpret=True)
    assert flash_attention.copies == before      # CPU: nothing is copied
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=2e-4)


def test_flash_wrapper_refuses_mismatched_heads_and_shapes():
    x = torch.zeros((2, 4, 64, 32))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention(x, x[:, :3], x[:, :3])
    with pytest.raises(ValueError, match="batch, sequence and head dim"):
        flash_attention(x, x[:1, :2], x[:1, :2])
    with pytest.raises(ValueError, match="batch, sequence and head dim"):
        flash_attention(x, x[:, :2, :32], x[:, :2, :32])
    with pytest.raises(ValueError, match="batch, sequence and head dim"):
        flash_attention(x, x[:, :2, :, :16], x[:, :2, :, :16])
    with pytest.raises(ValueError, match="shape"):
        flash_attention(x, x[:, :2], x[:, :1])


def test_flash_route_depends_on_dtype_and_head_dim_only():
    assert tensor_core_route(torch.bfloat16, 128)
    assert tensor_core_route(torch.bfloat16, 24)
    assert not tensor_core_route(torch.bfloat16, 136)
    assert not tensor_core_route(torch.float32, 64)


def test_flash_addressable_copies_only_what_the_kernel_cannot_read():
    """The wrapper's rule for copying an input: a last dim of stride
    other than 1, or a base or a stride (of a dim longer than 1) that is
    not a positive multiple of 16 bytes."""
    base = torch.zeros((2, 16, 4, 72), dtype=torch.bfloat16)
    view = base[..., :64].transpose(1, 2)              # (B, H, S, D) view
    one_head = torch.zeros((2, 1, 16, 64)).expand(2, 4, 16, 64)
    before = flash_attention.copies
    assert _addressable(view) is view
    assert _addressable(base[:1, :, :1]) is not None
    assert flash_attention.copies == before
    for bad in (base[..., 4:68],                        # base 8 B off
                base[..., :64].transpose(2, 3),         # last dim strided
                torch.zeros((2, 16, 4, 60),
                            dtype=torch.bfloat16)[..., :56],  # 120 B rows
                one_head):                              # a zero stride
        n = flash_attention.copies
        out = _addressable(bad)
        assert flash_attention.copies == n + 1
        assert out.is_contiguous() and out.data_ptr() % 16 == 0
        assert torch.equal(out, bad)


# The tensor-core route's arithmetic, emulated in float32 on the CPU: bf16
# inputs, exact products summed in fp32 (wgmma), scores scaled after the
# product, base-2 exponentials, P rounded to bf16 before P.V, the row sum
# of the unrounded fp32 P, 64 query rows a warpgroup against 128-key
# tiles, output rounded to bf16.
def _tc_route_emulation(q, k, v, window=None, block_m=64, block_n=128,
                        causal=True):
    B, H, S, D = q.shape
    sl2 = D ** -0.5 * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((B, H, S, D))
    for q0 in range(0, S, block_m):
        rows = torch.arange(q0, min(q0 + block_m, S))
        m = torch.full((B, H, len(rows)), -math.inf)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), D))
        t_hi = -(-S // block_n)
        if causal:
            t_hi = min(t_hi, rows[-1].item() // block_n + 1)
        t_lo = 0 if window is None else max(q0 - window + 1, 0) // block_n
        for t in range(t_lo, t_hi):
            keys = torch.arange(t * block_n, min((t + 1) * block_n, S))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            see = torch.ones((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                see &= keys[None, :] <= rows[:, None]
            if window is not None:
                see &= keys[None, :] > rows[:, None] - window
            s = torch.where(see, s, -math.inf)
            mx = torch.maximum(m, s.amax(-1))
            base = torch.where(mx == -math.inf, 0.0, mx * sl2)
            alpha = torch.exp2(m * sl2 - base)
            p = torch.exp2(s * sl2 - base[..., None])
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + p.bfloat16().float() @ vf[:, :, keys])
            m = mx
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.bfloat16()


@pytest.mark.parametrize("window,causal,S,D", [
    (None, True, 1024, 128), (200, True, 1024, 128),
    (None, False, 1500, 64),        # Whisper's encoder: non-causal, ragged
    (None, True, 448, 64)])         # Whisper's decoder: ragged
def test_tensor_core_numerics_stay_within_the_card_tolerance(window, causal,
                                                             S, D):
    """At (1, 2, 1024, 128), and at Whisper's encoder and decoder shapes,
    the emulated tensor-core route stays within chip_smoke's bf16 ATTN_TOL
    (1e-2) of the plain version in f32, as the card is held to it."""
    q, k, v = (_t(_rand((1, 2, S, D), 60 + i), torch.bfloat16)
               for i in range(3))
    got = _tc_route_emulation(q, k, v, window, causal=causal)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         sliding_window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# attention() on each branch
# ---------------------------------------------------------------------------

ACFG = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
            use_rope=True)


def _attn_pair(seed=0, **over):
    jcfg = j_attn.AttentionConfig(**ACFG, **over)
    tcfg = t_attn.AttentionConfig(**ACFG, **over)
    jp = j_attn.attention_init(jax.random.PRNGKey(seed), jcfg)
    # non-unit norm scales, so qk-norm's scale path is exercised
    for name in ("q_norm", "k_norm"):
        jp[name]["scale"] = jnp.asarray(
            1.0 + 0.1 * _rand((16,), seed + len(name)))
    return jcfg, tcfg, jp, params_from_jax(jp, device="cpu")


def _check_attention(S, mask=False, seed=0, **over):
    jcfg, tcfg, jp, tp = _attn_pair(seed, **over)
    x = _rand((2, S, 64), seed + 1)
    jm = tm = None
    if mask:
        jm = j_attn.make_attention_mask(jcfg, S, S)
        tm = t_attn.make_attention_mask(tcfg, S, S)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    # K5 takes every core without a caller mask or a logit softcap,
    # causal or not, at any S
    assert t_attn.flash_eligible(tcfg, tm) == (
        not mask and over.get("attn_logit_softcap") is None)
    got = t_attn.attention(tp, tcfg, _t(x), mask=tm)
    want = j_attn.attention(jp, jcfg, jnp.asarray(x), mask=jm)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_attention_scores_branch_with_a_mask(window):
    _check_attention(64, mask=True, sliding_window=window)


@pytest.mark.parametrize("skip", [False, True])
def test_attention_chunked_branch(skip):
    """A softcap takes the core off K5; above the threshold the
    reference's chunked path runs."""
    _check_attention(64, attn_logit_softcap=30.0, chunked_threshold=16,
                     block_q=16, block_k=16, skip_masked_blocks=skip,
                     sliding_window=8)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("causal,S", [(True, 64), (False, 64), (True, 200),
                                      (False, 200)])
def test_attention_flash_branch(window, causal, S):
    """Eligible: the core is K5's plain version on the CPU, held against
    the reference's ``_scores_to_out``; non-causal (Whisper's encoder) and
    at a length 128 does not tile (blocks of S)."""
    _check_attention(S, sliding_window=window, causal=causal)


def test_attention_flash_branch_reads_projections_in_place(monkeypatch):
    """On the flash branch the KV heads are never repeated and nothing is
    made contiguous: K5 takes the (B, S, H, D) projections as views and
    maps the GQA heads itself.  The result still matches the reference's
    ``attention`` for a GQA config (4 query heads over 2 KV heads)."""
    def refuse(*a, **k):
        raise AssertionError("the flash branch copied its inputs")
    monkeypatch.setattr(t_attn, "_repeat_kv", refuse)
    monkeypatch.setattr(torch.Tensor, "contiguous", refuse)
    _check_attention(64, sliding_window=8)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("window", [None, 8])
def test_chunked_attention_matches(skip, window):
    over = dict(chunked_threshold=16, block_q=16, block_k=16,
                skip_masked_blocks=skip, sliding_window=window)
    jcfg = j_attn.AttentionConfig(**ACFG, **over)
    tcfg = t_attn.AttentionConfig(**ACFG, **over)
    q, k, v = (_rand((2, 64, 4, 16), 30 + i) for i in range(3))
    got = t_attn.chunked_attention(tcfg, _t(q), _t(k), _t(v))
    want = j_attn.chunked_attention(jcfg, *(jnp.asarray(a)
                                            for a in (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# which configurations' self-attention cores take K5 (at any length:
# Whisper's 1,500-frame non-causal encoder and 448-position decoder,
# llava's 2,880 patches + 128 tokens)
K5_ARCHS = {
    "qwen3-0.6b": True, "qwen2.5-14b": True, "llama3-8b": True,
    "llama4-scout-17b-a16e": True, "minitron-8b": True,
    "qwen2-moe-a2.7b": True, "llava-next-mistral-7b": True,
    "whisper-medium": True,
    "recurrentgemma-9b": False,      # logit softcap on its swa blocks
    "mamba2-130m": None,             # attention-free
    "granite-4.0-h-small": True,     # NoPE, its 1/128 scale passed to K5
    "moonlight-16b-a3b": True,       # MLA: values narrower than keys, bf16
}


def mla_takes_k5(m) -> bool:
    """Whether K5 (its checks on ``meta``, which launch nothing) takes an
    MLA core of these widths in bf16."""
    q = torch.empty((1, m.n_heads, 128, m.qk_head_dim), dtype=torch.bfloat16,
                    device="meta")
    v = torch.empty((1, m.n_heads, 128, m.v_head_dim), dtype=torch.bfloat16,
                    device="meta")
    try:
        flash_attention(q, q, v, scale=m.softmax_scale)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("reduced", [False, True])
def test_which_configs_take_k5(reduced):
    from repro_torch.models.whisper import _attn_cfg as whisper_cfg
    got = {}
    for arch, cfg in ARCHS.items():
        cfg = cfg.reduced() if reduced else cfg
        if cfg.family == "audio":
            cores = [whisper_cfg(cfg, causal=c) for c in (False, True)]
        else:
            cores = [attn_config(cfg, kd) for kd in cfg.blocks()
                     if kd in ("attn", "swa")]
        eligible = [t_attn.flash_eligible(c, None) for c in cores]
        # an MLA core takes K5 in bf16, the dtype its configs serve in:
        # the kernel's checks (on meta) accept its widths
        eligible += [mla_takes_k5(mla_config(cfg))
                     for kd in cfg.blocks() if kd == "mla"]
        got[arch] = None if not eligible else all(eligible)
    assert got == K5_ARCHS


def test_attn_config_matches_reference():
    from repro.configs import ARCHS as J_ARCHS
    for arch in J_ARCHS:      # the port's own configs have no reference
        cfg = ARCHS[arch]
        for kind in ("attn", "swa"):
            for long_ctx in (False, True):
                assert port_only_dict(attn_config(
                    cfg, kind, long_ctx=long_ctx)) == dataclasses.asdict(
                    j_attn_config(J_ARCHS[arch], kind, long_ctx=long_ctx))


# ---------------------------------------------------------------------------
# the layers under attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = _rand((2, 24, 3, 32), 1)
    pos = np.random.default_rng(2).integers(0, 200, (2, 24))
    got = apply_rope(_t(x), torch.from_numpy(pos), theta=theta)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    x = _rand((2, 5, 48), 3, scale=3.0) + 0.5
    p = {"scale": _rand((48,), 4) + 1.0, "bias": _rand((48,), 5)}
    if norm == "rmsnorm":
        p.pop("bias")
    got = getattr(t_layers, norm)({k: _t(v) for k, v in p.items()}, _t(x))
    want = getattr(j_layers, norm)({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu_mlp", "relu2"])
def test_mlps(mlp):
    """Each MLP kind against the reference's.  The squared ReLU
    (minitron-8b) has no function in ``nn.layers``: both packages compute
    it in ``models.blocks.mlp_apply`` over ``mlp_init``'s bias-free
    up/down pair."""
    x = _rand((2, 7, 32), 6)
    if mlp == "relu2":
        from repro.models import blocks as j_blocks
        from repro_torch.models import blocks as t_blocks
        cfg = dataclasses.replace(ARCHS["minitron-8b"].reduced(), d_model=32,
                                  d_ff=96)
        assert cfg.mlp == "relu2"
        jp = j_blocks.mlp_init(KeyGen(jax.random.PRNGKey(9))(), cfg,
                               jnp.float32)
        assert sorted(jp) == ["down", "up"] and "bias" not in jp["up"]
        got = t_blocks.mlp_apply(cfg, params_from_jax(jp, device="cpu"),
                                 _t(x))
        want = j_blocks.mlp_apply(cfg, jp, jnp.asarray(x))
    else:
        jp = getattr(j_layers, mlp + "_init")(
            KeyGen(jax.random.PRNGKey(9))(), 32, 96)
        got = getattr(t_layers, mlp)(params_from_jax(jp, device="cpu"),
                                     _t(x))
        want = getattr(j_layers, mlp)(jp, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
