"""The three dense decoders the port had held only field by field
(llama3-8b, qwen2.5-14b, minitron-8b) against the reference on the CPU,
as whole models at ``reduced()`` in f32, and a grouped-query variant at
qwen2.5-14b's published group of 5 query heads a KV head.

What they bring that qwen3-0.6b does not: the QKV bias (qwen2.5), the
squared-ReLU MLP and LayerNorm with its bias inside a decoder block
(minitron), untied embeddings and head (all three).  ``reduced()`` caps
the heads at 4, so a group of 5 appears only in the variant
``dataclasses.replace(cfg.reduced(), n_heads=10, n_kv_heads=2)``, applied
equally to both packages' configurations.  On the CPU its attention cores
take K5's plain version (``nn.attention.flash_eligible``), so the
variant holds that version at a group of 5 against the reference's
``_scores_to_out``.

Parameters are the reference's own ``DecoderModel.init`` at
``PRNGKey(0)`` (the key the reference's ``build_split`` draws with),
converted with ``params_from_jax``, never re-initialised in the port;
the reference initialises biases to 0 and norm scales to 1, so the
fixture sets them from numpy with a seed in the reference's tree first,
or a port that dropped them would pass.  Tokens come from numpy with a
seed.  Tolerance: 1e-5 of the largest
logit for the forward, the float32-codec split and 8 decode steps over an
f32 cache (the two frameworks sum in other orders).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.launch.serve import build_split as j_build_split  # noqa: E402
from repro.models.transformer import DecoderModel as JDecoder  # noqa: E402
from repro.nn import attention as j_attn  # noqa: E402

from repro_torch.models.config import port_only_dict
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.wire import get_codec  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models.blocks import attn_config  # noqa: E402
from repro_torch.models.transformer import DecoderModel  # noqa: E402

# One intra-op thread a process: the suite runs a pytest worker a core,
# and torch's default (a thread a core in every worker) oversubscribes
# the host many times over.
torch.set_num_threads(1)

DENSE = ("llama3-8b", "qwen2.5-14b", "minitron-8b")
GQA5 = "qwen2.5-14b-gqa5"
TOL = 1e-5
N_DECODE = 8


def _config(case, pkg_archs):
    """The case's reduced config, from ``pkg_archs`` (either package's)."""
    if case == GQA5:
        return dataclasses.replace(pkg_archs["qwen2.5-14b"].reduced(),
                                   n_heads=10, n_kv_heads=2)
    return pkg_archs[case].reduced()


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(3, vocab, shape,
                                                dtype=np.int32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    """|got - want| within ``tol`` of want's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * scale, f"max_abs_err {err:.3g} over {tol} x {scale:.4g}"


@pytest.fixture(scope="module", params=DENSE + (GQA5,))
def dense(request):
    """(case, port cfg, port model, port params, ref model, ref params)."""
    jcfg = _config(request.param, J_ARCHS)
    cfg = _config(request.param, ARCHS)
    assert port_only_dict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JDecoder(jcfg)
    jp = _perturbed(jmodel.init(jax.random.PRNGKey(0)),
                    np.random.default_rng(7))
    return (request.param, cfg, DecoderModel(cfg),
            params_from_jax(jp, device="cpu"), jmodel, jp)


def _perturbed(tree, rng):
    """``tree`` with every ``bias`` leaf drawn from N(0, 0.1^2) and every
    ``scale`` leaf from 1 + N(0, 0.1^2)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif k in ("bias", "scale"):
            x = 0.1 * rng.standard_normal(v.shape)
            out[k] = jnp.asarray(x + (k == "scale"), v.dtype)
        else:
            out[k] = v
    return out


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


def test_reduced_configs_keep_what_sets_each_apart():
    """The features the three configs bring survive ``reduced()`` in both
    packages, and the variant has its group of 5."""
    want = {"llama3-8b": ("swiglu", "rmsnorm", False),
            "qwen2.5-14b": ("swiglu", "rmsnorm", True),
            "minitron-8b": ("relu2", "layernorm", False)}
    for arch, (mlp, norm, bias) in want.items():
        for archs in (ARCHS, J_ARCHS):
            full, red = archs[arch], archs[arch].reduced()
            assert (full.mlp, full.norm, full.qkv_bias) == (mlp, norm, bias)
            assert (red.mlp, red.norm, red.qkv_bias) == (mlp, norm, bias)
            assert not red.tie_embeddings and red.dtype == "float32"
    assert ARCHS["qwen2.5-14b"].n_heads // ARCHS["qwen2.5-14b"].n_kv_heads \
        == 5
    g5 = _config(GQA5, ARCHS)
    assert g5.n_heads // g5.n_kv_heads == 5


def test_port_init_has_the_reference_tree(dense):
    """The port draws the reference's tree: the QKV-bias leaves, the
    LayerNorm ``bias`` leaves and the untied head where the config has
    them; conversion carries every leaf with its shape."""
    case, cfg, model, tp, _, jp = dense
    own = dict(_paths(model.init(torch.Generator().manual_seed(0),
                                 device="cpu")))
    assert own == dict(_paths(jp)) == dict(_paths(tp))
    attn = tp["scan"]["b0_attn"]["attn"]
    assert ("bias" in attn["wq"]) == cfg.qkv_bias == ("bias" in attn["wk"])
    assert "bias" not in attn["wo"]
    assert ("bias" in tp["scan"]["b0_attn"]["norm1"]) == \
        (cfg.norm == "layernorm")
    assert "lm_head" in tp


def test_forward_matches_the_reference(dense):
    _, cfg, model, tp, jmodel, jp = dense
    tok = _tokens((2, 16), cfg.vocab)
    got, aux = model.forward(tp, torch.from_numpy(tok))
    want, _ = jmodel.forward(jp, jnp.asarray(tok))
    assert got.shape == (2, 16, cfg.vocab) and got.dtype == torch.float32
    assert float(aux["moe_aux_loss"]) == 0.0
    _close(got, want)


def test_float32_split_matches_the_reference(dense):
    """The float32 codec's split at one edge segment: the two models'
    split halves through the codec; for the published configs also
    ``build_split`` of each package on the parameters the reference's
    draws (``PRNGKey(0)``, handed to the port), the port's split bit for
    bit its own monolith."""
    case, cfg, model, tp, jmodel, jp = dense
    tok = _tokens((1, 16), cfg.vocab, seed=2)
    codec = get_codec("float32")
    te, ts = model.split_params(tp, 1)
    je, js = jmodel.split_params(jp, 1)
    got = model.server_forward(ts, codec.decode(
        codec.encode(model.edge_forward(te, torch.from_numpy(tok))),
        dtype=torch.float32))
    want = jmodel.server_forward(js, jmodel.edge_forward(
        je, jnp.asarray(tok)))
    _close(got, want)
    if case in DENSE:
        kw = dict(reduced=True, edge_segments=1, codec_name="float32",
                  batch=1, seq=16)
        drawn = params_from_jax(jmodel.init(jax.random.PRNGKey(0)),
                                device="cpu")
        (_, edge, server, mono, *_) = t_serve.build_split(
            case, device="cpu", params=drawn, **kw)
        (_, j_edge, j_server, *_) = j_build_split(case, **kw)
        got = server(edge(torch.from_numpy(tok)))
        assert torch.equal(got, mono(torch.from_numpy(tok)))
        _close(got, j_server(j_edge(jnp.asarray(tok))))


def test_decode_steps_match_the_reference(dense):
    _, cfg, model, tp, jmodel, jp = dense
    tok = _tokens((1, N_DECODE), cfg.vocab, seed=3)
    step = jax.jit(jmodel.decode_step)
    jc = jmodel.init_cache(1, N_DECODE, jnp.float32)
    tc = model.init_cache(1, N_DECODE, torch.float32, device="cpu")
    index = torch.zeros((), dtype=torch.int64)
    got, want = [], []
    for t in range(N_DECODE):
        lg, jc = step(jp, jnp.asarray(tok[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = model.decode_step(tp, torch.from_numpy(tok[:, t:t + 1]),
                                   tc, index)
        index += 1
        want.append(np.asarray(lg, np.float32))
        got.append(_np(tl))
    _close(np.concatenate(got, 1), np.concatenate(want, 1))


@pytest.mark.parametrize("window", [None, 5])
def test_group_of_five_core_is_k5s_plain_version(window):
    """K5's plain version (what the port's cores run on the CPU, and what
    chip_smoke holds the card's K5 against) at 10 query heads over 2 KV
    heads against the reference's ``_scores_to_out`` on K/V repeated to
    the query heads, causal, with and without a window."""
    g5 = _config(GQA5, ARCHS)
    jcfg = j_attn.AttentionConfig(
        d_model=g5.d_model, n_heads=g5.n_heads, n_kv_heads=g5.n_kv_heads,
        head_dim=g5.head_dim, sliding_window=window)
    rng = np.random.default_rng(5)
    S, H, H_kv, D = 24, g5.n_heads, g5.n_kv_heads, g5.head_dim
    q = rng.standard_normal((1, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, H_kv, D)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(*(torch.from_numpy(a).transpose(1, 2)
                            for a in (q, k, v)),
                          causal=True, sliding_window=window,
                          block_q=S, block_k=S).transpose(1, 2)
    mask = j_attn.make_attention_mask(jcfg, S, S)
    want = j_attn._scores_to_out(
        jcfg, jnp.asarray(q), j_attn._repeat_kv(jnp.asarray(k), H // H_kv),
        j_attn._repeat_kv(jnp.asarray(v), H // H_kv), mask)
    _close(got, want)
    # the attention block's config reaches K5 with the group intact
    acfg = attn_config(g5, "attn")
    assert (acfg.n_heads, acfg.n_kv_heads, acfg.qkv_bias) == (10, 2, True)
