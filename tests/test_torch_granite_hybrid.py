"""granite-4.0-h-small on the port's LM path, held against the plain
reference (``bench/reference/hybrid_lm.py``: plain torch in float32) on
seeded random weights at ``ArchConfig.reduced()``'s widths, on the CPU.

Both sides compute in float32 here, so they differ only by the order of
their sums (the SSD's chunked forms, K5's and K7's plain versions against
the reference's loops): every tolerance below is a float32 one, set far
under what a dropped term, a missing multiplier or a wrong expert moves.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro.nn.moe import MoEConfig as JMoEConfig  # noqa: E402
from repro.nn.moe import moe_apply as j_moe_apply  # noqa: E402
from repro.nn.moe import moe_init as j_moe_init  # noqa: E402

from bench.reference import hybrid_lm as ref  # noqa: E402
from bench.systems.hybrid_lm import arch_config, program_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.wire import get_codec  # noqa: E402
from repro_torch.kernels.moe_grouped import moe_grouped, tiles_bound  # noqa: E402
from repro_torch.kernels.ref import moe_grouped_ref  # noqa: E402
from repro_torch.models.blocks import moe_config  # noqa: E402
from repro_torch.models.transformer import DecoderModel  # noqa: E402
from repro_torch.nn import moe as t_moe  # noqa: E402
from repro_torch.nn.module import tree_map  # noqa: E402

# float32 against float32: logits of RMS about 0.1 agree to about 1e-6 of
# the largest; 1e-4 leaves room for the sums' order and is 100x under
# what switching off the smallest multiplier moves (test below)
LOGIT_TOL = 1e-4
B, S = 2, 16


def reduced_config(layers=("mamba", "attention") * 2, edge: int = 2):
    """The reference's configuration dict at ``reduced()``'s widths of the
    published config: two periods of (Mamba-2, attention), as the program
    stacks them."""
    r = get_config("granite-4.0-h-small").reduced()
    s, m = r.ssm, r.moe
    return {
        "name": "granite-4.0-h-small.reduced", "arch": "granite-4.0-h-small",
        "hidden_size": r.d_model, "num_attention_heads": r.n_heads,
        "num_key_value_heads": r.n_kv_heads, "head_dim": r.head_dim,
        "intermediate_size": r.d_ff, "shared_intermediate_size":
        m.d_ff_shared, "num_local_experts": m.n_experts,
        "num_experts_per_tok": m.top_k, "vocab_size": r.vocab,
        "mamba_d_state": s.d_state, "mamba_d_head": s.head_dim,
        "mamba_expand": s.expand, "mamba_n_groups": s.n_groups,
        "mamba_d_conv": s.conv_width, "mamba_chunk_size": s.chunk,
        "mamba_n_heads": s.expand * r.d_model // s.head_dim,
        "mamba_conv_bias": True, "mamba_proj_bias": False,
        "attention_bias": False, "hidden_act": "silu",
        "normalization_function": "rmsnorm",
        "position_embedding_type": "nope", "tie_word_embeddings": True,
        "rms_norm_eps": r.norm_eps,
        "attention_multiplier": r.attention_multiplier,
        "embedding_multiplier": r.embedding_multiplier,
        "residual_multiplier": r.residual_multiplier,
        "logits_scaling": r.logits_scaling, "layer_types": list(layers),
        "num_hidden_layers": len(layers), "edge_layers": edge,
        "dtype": "float32"}


def setup(seed=5, **over):
    """(reference config, inputs, program cfg, model, program params in
    float32, the tokens)."""
    config = reduced_config()
    params = {"pool_batches": 1, "frames_per_tick": B, "seq_len": S}
    inputs = ref.make_inputs(config, params, seed, "cpu")
    cfg = dataclasses.replace(arch_config(config), **over)
    model = DecoderModel(cfg)
    tp = tree_map(lambda t: t.float(), program_params(inputs))
    return config, inputs, cfg, model, tp, inputs["tokens"][0]


def reference_logits(config, inputs, tokens):
    x = ref.embed(config, inputs, tokens)
    x, _, _ = ref.run_layers(config, inputs, x, 0,
                             config["num_hidden_layers"])
    return ref.head(config, inputs, x, lambda t: t.float())


def test_reduced_keeps_one_ssm_and_one_attn_layer():
    r = get_config("granite-4.0-h-small").reduced()
    assert sorted(r.blocks()) == ["attn", "ssm"]
    assert r.moe.dropless and r.ssm_ffn and not r.use_rope
    cfg = arch_config(reduced_config())
    assert cfg.blocks() == ["ssm", "attn"] * 2
    assert dataclasses.replace(cfg, n_layers=2, pattern=r.pattern,
                               n_pattern=0, remainder=r.remainder) == r


def test_published_config():
    c = get_config("granite-4.0-h-small")
    blocks = c.blocks()
    assert len(blocks) == 40 and [i for i, b in enumerate(blocks)
                                  if b == "attn"] == [5, 15, 25, 35]
    assert c.param_count() == 32_205_176_832
    assert (c.moe.n_experts, c.moe.top_k, c.moe.shared_width(c.d_ff)) == \
        (72, 10, 1536)


def test_forward_matches_the_reference():
    config, inputs, cfg, model, tp, tok = setup()
    routes = []
    with torch.no_grad(), t_moe.recorded_routes(routes):
        logits, _ = model.forward(tp, tok, last_only=True)
    want = reference_logits(config, inputs, tok)
    scale = want.abs().max()
    assert (logits[:, 0] - want).abs().max() <= LOGIT_TOL * scale
    # the same experts chosen in every layer
    x = ref.embed(config, inputs, tok)
    _, own, route = ref.run_layers(config, inputs, x, 0, 4,
                                   routes=torch.stack(routes))
    assert route[0] == 0 and len(routes) == 4    # no token's set differs


def test_split_with_the_uint8_codec_matches_the_reference():
    """Edge, per-example uint8 codec, server at ``last_only``: the codes
    within one step of the reference's boundary hidden, the logits the
    reference server's on the same payload."""
    config, inputs, cfg, model, tp, tok = setup(seed=6)
    edge_p, server_p = model.split_params(tp, 1)
    codec = get_codec("uint8")
    with torch.no_grad():
        payload = codec.encode_batch(model.edge_forward(edge_p, tok))
        logits = model.server_forward(server_p, codec.decode_batch(payload),
                                      last_only=True)
    assert logits.shape == (B, 1, cfg.vocab)
    x, _, _ = ref.run_layers(config, inputs, ref.embed(config, inputs, tok),
                             0, 2)
    codes, scale, zero = ref.quantise(x)
    # float32 both sides: a code may differ by one where the hidden lies
    # at a rounding half step
    assert (payload["data"].int() - codes.int()).abs().max() <= 1
    torch.testing.assert_close(payload["scale"], scale, rtol=1e-5, atol=0)
    y, _, _ = ref.run_layers(config, inputs,
                             ref.dequantise(payload["data"],
                                            payload["scale"],
                                            payload["zero"]), 2, 4)
    want = ref.head(config, inputs, y, lambda t: t.float())
    assert (logits[:, 0] - want).abs().max() <= LOGIT_TOL * want.abs().max()


def test_prefill_then_decode_matches_the_forward():
    """Eight prompt tokens through the caches, then eight more decoded:
    every position's logits the full forward's, and the last the
    reference's."""
    config, inputs, cfg, model, tp, tok = setup(seed=7)
    with torch.no_grad():
        full, _ = model.forward(tp, tok)
    caches = model.init_cache(B, S, torch.float32, device="cpu")
    steps = []
    for i in range(S):          # positions 0-7 the prompt, 8-15 decoded
        out, caches = model.decode_step(tp, tok[:, i:i + 1], caches, i)
        steps.append(out)
    got = torch.cat(steps, 1)
    assert (got - full).abs().max() <= LOGIT_TOL * full.abs().max()
    want = reference_logits(config, inputs, tok)
    assert (got[:, -1] - want).abs().max() <= LOGIT_TOL * want.abs().max()


def test_forced_imbalance_drops_nothing():
    """Every token routed to expert 0 first: the dropless layer computes
    all B S K pairs and matches the reference's loop over experts."""
    config, inputs, cfg, model, tp, tok = setup(seed=8)
    w = inputs["layers"][0]
    router = w["router"].clone()
    router[:, 0] = 10.0                       # x >= 0 below: expert 0 wins
    x = torch.rand((B, S, cfg.d_model), generator=torch.Generator()
                   .manual_seed(1))
    p = tree_map(lambda t: t.float(), program_params(inputs))["scan"]
    mp = tree_map(lambda t: t[0], p["b0_ssm"]["moe"])
    mp["router"]["kernel"] = router
    t_moe.reset_counters()
    y, aux = t_moe.moe_apply(mp, moe_config(cfg), x)
    counts = t_moe.dropless_counters()
    assert counts["routed_rows"] == B * S * cfg.moe.top_k
    assert counts["max_expert_rows"] == B * S            # all of them
    assert bool((aux["expert_idx"][..., 0] == 0).all())
    assert bool(aux["keep"].all())
    want, own, _ = ref.moe(config, {**{k: v.float() for k, v in w.items()},
                                    "router": router}, x, lambda t: t)
    assert bool((own[:, 0] == 0).all())
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_dropless_statistics_only_with_gradients():
    """The load-balance statistics are computed for a training step alone:
    with gradients off the aux holds the routing, and the output is the
    same bit for bit."""
    config, inputs, cfg, model, tp, tok = setup(seed=9)
    p = tree_map(lambda t: t.float(), program_params(inputs))["scan"]
    mp = tree_map(lambda t: t[0], p["b0_ssm"]["moe"])
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    y, aux = t_moe.moe_apply(mp, moe_config(cfg), x)
    assert {"moe_aux_loss", "router_entropy", "probs"} <= set(aux)
    assert float(aux["moe_aux_loss"]) > 0
    with torch.no_grad():
        y_off, aux_off = t_moe.moe_apply(mp, moe_config(cfg), x)
    assert set(aux_off) == {"expert_idx", "keep"}
    assert aux_off["expert_idx"].equal(aux["expert_idx"])
    assert y_off.equal(y.detach())


@pytest.mark.parametrize("off", [
    {"embedding_multiplier": 1.0}, {"residual_multiplier": 1.0},
    {"logits_scaling": 1.0}, {"attention_multiplier": None},
    {"use_rope": True}],
    ids=lambda d: next(iter(d)))
def test_each_granite_setting_moves_the_result(off):
    """Switched off one at a time (NoPE becomes RoPE), each moves the
    logits by far more than the float32 tolerance: the program applies
    every one."""
    config, inputs, cfg, model, tp, tok = setup(seed=9)
    want = reference_logits(config, inputs, tok)
    with torch.no_grad():
        on, _ = model.forward(tp, tok, last_only=True)
        other = DecoderModel(dataclasses.replace(cfg, **off))
        moved, _ = other.forward(tp, tok, last_only=True)
    assert (on[:, 0] - want).abs().max() <= LOGIT_TOL * want.abs().max()
    assert (moved[:, 0] - want).abs().max() > 10 * LOGIT_TOL \
        * want.abs().max()


def test_qwen2_moe_keeps_its_capacity_route():
    """qwen2-moe's layer still routes by capacity and drops exactly the
    reference's pairs under a forced imbalance."""
    cfg = moe_config(get_config("qwen2-moe-a2.7b").reduced())
    assert not cfg.dropless
    jcfg = JMoEConfig(**{f.name: getattr(cfg, f.name) for f in
                         dataclasses.fields(JMoEConfig)})
    jp = j_moe_init(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jp, device="cpu")
    x = np.abs(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model))).astype(np.float32)
    router = np.array(jp["router"]["kernel"])
    router[:, 0] = 10.0
    jp["router"]["kernel"] = jnp.asarray(router)
    tp["router"]["kernel"] = torch.from_numpy(router)
    y, aux = t_moe.moe_apply(tp, cfg, torch.from_numpy(x))
    jy, _ = j_moe_apply(jp, jcfg, jnp.asarray(x))
    assert not aux["keep"].all()              # expert 0's queue overflows
    # the same pairs dropped: any other choice moves the output
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)


def test_k7_plain_version_and_wrapper_checks():
    g = torch.Generator().manual_seed(2)
    E, D, Fd = 3, 16, 8
    wg, wu = (torch.randn(E, D, Fd, generator=g) for _ in range(2))
    wd = torch.randn(E, Fd, D, generator=g)
    x = torch.randn(7, D, generator=g)
    off = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    scale = torch.rand(7, generator=g)
    got = moe_grouped(x, off, wg, wu, wd, row_scale=scale)
    for r in range(7):
        e = int((off[1:] <= r).sum())
        h = torch.nn.functional.silu(x[r] @ wg[e]) * (x[r] @ wu[e])
        torch.testing.assert_close(got[r], scale[r] * (h @ wd[e]))
    torch.testing.assert_close(got, moe_grouped_ref(x, off, wg, wu, wd,
                                                    scale))
    with pytest.raises(ValueError):
        moe_grouped(x, off[:3], wg, wu, wd)
    with pytest.raises(ValueError):
        moe_grouped(x[:, :8], off, wg, wu, wd)
    meta = moe_grouped(*(torch.empty(s, dtype=torch.bfloat16, device="meta")
                         for s in ((7, 256), )),
                       off.to("meta"),
                       *(torch.empty(s, dtype=torch.bfloat16, device="meta")
                         for s in ((E, 256, 128), (E, 256, 128),
                                   (E, 128, 256))))
    assert meta.shape == (7, 256) and meta.dtype == torch.float32
    # the grid's row tiles: every expert's last one may be partial
    assert tiles_bound(81920, 72) == 640 + 72 and tiles_bound(0, 4) == 4
