"""Moonlight-16B-A3B (DeepSeek-V3's block) on the port's LM path, held
against the plain reference (``bench/reference/mla_lm.py``: plain torch in
float32), and the reference against transformers' ``DeepseekV3ForCausalLM``,
on seeded random weights at a tiny size (d_model 64, 4 heads, 8 experts
top-2, 3 layers: the dense lead layer and two MoE layers), on the CPU.

Both sides compute in float32 except where a test says bf16, so they
differ only by the order of their sums (the absorbed decode against the
decompressed forward, the experts' loop against K7's plain version): each
float32 tolerance is set far under what a dropped term, a missing scale or
a wrong expert moves (the router tests plant such faults).
"""
import copy
import dataclasses
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402
from bench.reference import mla_lm as ref  # noqa: E402
from bench.systems.mla_lm import arch_config, program_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.wire import get_codec  # noqa: E402
from repro_torch.costs import attention_flops  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 tensor_core_route)
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models.blocks import mla_config, moe_config  # noqa: E402
from repro_torch.models.config import port_only_dict  # noqa: E402
from repro_torch.models.transformer import DecoderModel  # noqa: E402
from repro_torch.nn import mla as t_mla  # noqa: E402
from repro_torch.nn import moe as t_moe  # noqa: E402
from repro_torch.nn.module import tree_map  # noqa: E402

torch.set_num_threads(1)

CELL = "moonlight.pf2x8192"
B, S = 2, 16
# float32 against float32: logits of RMS about 1 agree to about 1e-6 of the
# largest; 1e-4 leaves room for the sums' order and is far under what
# dropping the routed scale (2.446) or the correction bias moves
LOGIT_TOL = 1e-4
# bf16 weights, activations and residual stream against float32: the tiny
# model's logits move by about 1% of the largest (bf16's 2^-8 a rounding,
# over three layers); 5% is still under what a dropped scale moves (> 30%)
BF16_TOL = 5e-2


def tiny_config(layers: int = 3, edge: int = 2) -> dict:
    """The cell's configuration file at tiny widths: every key of the
    published config, the widths narrowed."""
    _, _, config = harness.load_cell(CELL)
    config = copy.deepcopy(config)
    config.update(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=4, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  intermediate_size=96, moe_intermediate_size=32,
                  n_routed_experts=8, num_experts_per_tok=2, vocab_size=256,
                  num_hidden_layers=layers, edge_layers=edge)
    return config


def setup(seed=5, dtype=torch.float32, **over):
    """(reference config, inputs, program cfg, model, program params in
    ``dtype``, the tokens)."""
    config = tiny_config(**over)
    params = {"pool_batches": 1, "frames_per_tick": B, "seq_len": S}
    inputs = ref.make_inputs(config, params, seed, "cpu")
    cfg = dataclasses.replace(arch_config(config),
                              dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    model = DecoderModel(cfg)
    tp = tree_map(lambda t: t.to(dtype), program_params(inputs))
    # the router's weights and bias stay float32, as the program holds them
    tp["scan"]["b0_mla"]["moe"]["router"]["kernel"] = \
        inputs["stack"]["router"]
    tp["scan"]["b0_mla"]["moe"]["e_score_correction_bias"] = \
        inputs["stack"]["bias"]
    return config, inputs, cfg, model, tp, inputs["tokens"][0]


def rel_gap(got, want):
    return ((got.float() - want).abs().max() / want.abs().max()).item()


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------

def test_published_config():
    c = get_config("moonlight-16b-a3b")
    assert len(c.blocks()) == 27 and c.lead == ("mla",)
    assert c.blocks() == ["mla"] * 27 and c.n_pattern == 26
    assert c.param_count() == 15_959_982_080          # 31.9 GB in bf16
    assert (c.moe.n_experts, c.moe.top_k, c.moe.shared_width(c.d_ff),
            c.moe.router, c.moe.routed_scaling) == (64, 6, 2816,
                                                    "sigmoid_bias", 2.446)
    assert (c.mla.kv_lora_rank, c.mla.qk_head_dim, c.mla.v_head_dim) == \
        (512, 192, 128)
    m = mla_config(c)
    assert m.softmax_scale == 192 ** -0.5 and m.rope_theta == 50000.0
    # K5 (its checks on meta) takes the core in bf16 and refuses float32
    q = torch.empty((2, 16, 64, 192), dtype=torch.bfloat16, device="meta")
    v = torch.empty((2, 16, 64, 128), dtype=torch.bfloat16, device="meta")
    assert flash_attention(q, q, v, scale=m.softmax_scale).shape == v.shape
    with pytest.raises(ValueError, match="tensor-core route"):
        flash_attention(q.float(), q.float(), v.float())
    # the port's additions show in its dict, so the JAX package has no
    # config it could be confused with
    d = port_only_dict(c)
    assert d["mla"]["kv_lora_rank"] == 512 and d["lead"] == ("mla",)
    assert d["moe"]["router"] == "sigmoid_bias"


def test_bench_config_is_the_published_one():
    _, _, config = harness.load_cell(CELL)
    assert config["reduced"] == [] and config["num_hidden_layers"] == 27
    assert arch_config(config) == get_config("moonlight-16b-a3b")


def test_reduced_keeps_the_dense_lead_and_the_moe():
    r = get_config("moonlight-16b-a3b").reduced()
    assert r.blocks() == ["mla"] * 3 and r.lead == ("mla",)
    model = DecoderModel(r)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert "mlp" in p["lead0_mla"] and "moe" in p["scan"]["b0_mla"]
    assert p["lead0_mla"]["mlp"]["gate"]["kernel"].shape[1] == r.d_ff_dense
    bias = p["scan"]["b0_mla"]["moe"]["e_score_correction_bias"]
    assert bias.dtype == torch.float32 and bias.shape == (2, 4)


# ---------------------------------------------------------------------------
# The reference against transformers
# ---------------------------------------------------------------------------

def _hf_model(config: dict, inputs: dict):
    """transformers' DeepseekV3ForCausalLM in float32 with the reference's
    weights (its Linear weights are the transposes)."""
    tf = pytest.importorskip("transformers")
    c = config
    hf_cfg = tf.DeepseekV3Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        n_shared_experts=c["n_shared_experts"],
        n_routed_experts=c["n_routed_experts"],
        routed_scaling_factor=c["routed_scaling_factor"],
        kv_lora_rank=c["kv_lora_rank"], q_lora_rank=None,
        qk_rope_head_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], qk_nope_head_dim=c["qk_nope_head_dim"],
        n_group=c["n_group"], topk_group=c["topk_group"],
        num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"],
        norm_topk_prob=c["norm_topk_prob"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], tie_word_embeddings=False,
        rope_interleave=True, max_position_embeddings=64,
        attention_bias=False)
    hf_cfg._attn_implementation = "eager"
    model = tf.DeepseekV3ForCausalLM(hf_cfg).float().eval()

    def put(linear, w):
        linear.weight.data.copy_(w.float().T)

    m = model.model
    m.embed_tokens.weight.data.copy_(inputs["embed"].float())
    m.norm.weight.data.copy_(inputs["final_norm"].float())
    put(model.lm_head, inputs["lm_head"])
    for i, w in enumerate(inputs["layers"]):
        lay = m.layers[i]
        lay.input_layernorm.weight.data.copy_(w["norm1"].float())
        lay.post_attention_layernorm.weight.data.copy_(w["norm2"].float())
        a = lay.self_attn
        put(a.q_proj, w["wq"])
        put(a.kv_a_proj_with_mqa, w["wkv_a"])
        a.kv_a_layernorm.weight.data.copy_(w["kv_norm"].float())
        put(a.kv_b_proj, w["wkv_b"])
        put(a.o_proj, w["wo"])
        if i < c["first_k_dense_replace"]:
            put(lay.mlp.gate_proj, w["gate"])
            put(lay.mlp.up_proj, w["up"])
            put(lay.mlp.down_proj, w["down"])
            continue
        moe = lay.mlp
        moe.gate.weight.data.copy_(w["router"].float().T)
        moe.gate.e_score_correction_bias.copy_(w["bias"].float())
        for e, ex in enumerate(moe.experts):
            put(ex.gate_proj, w["w_gate"][e])
            put(ex.up_proj, w["w_up"][e])
            put(ex.down_proj, w["w_down"][e])
        put(moe.shared_experts.gate_proj, w["s_gate"])
        put(moe.shared_experts.up_proj, w["s_up"])
        put(moe.shared_experts.down_proj, w["s_down"])
    return model


def test_reference_matches_transformers():
    config, inputs, *_, tok = setup(seed=7)
    model = _hf_model(config, inputs)
    with torch.no_grad():
        want = model(tok).logits
    got = ref.forward_logits(config, inputs, tok)[0]
    assert rel_gap(got, want) <= LOGIT_TOL
    # the bias and the routed scale both act: without either the logits
    # move by far more than the tolerance
    for key, value in (("routed_scaling_factor", 1.0),):
        other = dict(config, **{key: value})
        assert rel_gap(ref.forward_logits(other, inputs, tok)[0], want) > \
            100 * LOGIT_TOL
    saved = [w["bias"].clone() for w in inputs["layers"][1:]]
    for w in inputs["layers"][1:]:
        w["bias"].zero_()
    moved = rel_gap(ref.forward_logits(config, inputs, tok)[0], want)
    for w, b in zip(inputs["layers"][1:], saved):
        w["bias"].copy_(b)
    assert moved > 100 * LOGIT_TOL


def test_bias_moves_at_least_a_twentieth_of_the_choices():
    """At the drawn scale the correction bias changes the chosen set of
    more than 5% of the (token, layer) pairs (at the tiny widths; the
    cell's share is in PERF.md)."""
    config, inputs, *_, tok = setup(seed=8)
    x = ref.embed(config, inputs, tok)
    _, own, _ = ref.run_layers(config, inputs, x, 0, 3, block=B)
    changed = 0
    for j, w in enumerate(inputs["layers"][1:]):
        h = torch.randn(B * S, config["hidden_size"],
                        generator=torch.Generator().manual_seed(j))
        logits = h @ w["router"].float()
        scores, key = ref.route_key(w, logits)
        a = torch.topk(key, 2).indices.sort(1).values
        b = torch.topk(scores, 2).indices.sort(1).values
        changed += int((a != b).any(1).sum())
    assert changed / (2 * B * S) >= 0.05
    assert own.shape == (2, B * S, 2)


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

def reference_logits(config, inputs, tokens):
    return ref.forward_logits(config, inputs, tokens)[0][:, -1]


def test_forward_matches_the_reference():
    config, inputs, cfg, model, tp, tok = setup()
    routes = []
    with torch.no_grad(), t_moe.recorded_routes(routes):
        logits, _ = model.forward(tp, tok)
    want = ref.forward_logits(config, inputs, tok)[0]
    assert rel_gap(logits, want) <= LOGIT_TOL
    # the same experts chosen in every MoE layer
    assert len(routes) == 2
    x = ref.embed(config, inputs, tok)
    _, _, route = ref.run_layers(config, inputs, x, 0, 3,
                                 routes=torch.stack(routes), block=B)
    assert route[0] == 0


def test_bf16_forward_takes_k5_and_matches_the_reference(monkeypatch):
    """In bf16 the MLA core goes through K5 (here its plain version) with
    values narrower than the keys, read in place from ``kv_b_proj``'s
    output."""
    config, inputs, cfg, model, tp, tok = setup(dtype=torch.bfloat16)
    calls = []
    real = t_mla.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape, k.shape, v.shape, v.stride(), kw["scale"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(t_mla, "flash_attention", spy)
    with torch.no_grad():
        logits, _ = model.forward(tp, tok, last_only=True)
    assert len(calls) == 3
    q, k, v, vs, scale = calls[0]
    assert q == k == (B, 4, S, 24) and v == (B, 4, S, 16)
    assert vs[2] == 4 * 32 and vs[1] == 32       # a slice of (B, S, H, 32)
    assert scale == 24 ** -0.5
    want = reference_logits(config, inputs, tok)
    assert rel_gap(logits[:, 0], want) <= BF16_TOL


def test_split_with_the_uint8_codec_matches_the_reference():
    """Edge (embedding, the dense lead layer, the first MoE layer), the
    per-example uint8 codec, the server at ``last_only``: the codes within
    one step of the reference's boundary hidden, the logits the reference
    server's on the same payload."""
    config, inputs, cfg, model, tp, tok = setup(seed=6)
    edge_p, server_p = model.split_params(tp, 1)
    assert "lead0_mla" in edge_p and "lead0_mla" not in server_p
    assert "lm_head" in server_p and "lm_head" not in edge_p
    codec = get_codec("uint8")
    with torch.no_grad():
        hidden = model.edge_forward(edge_p, tok)
        payload = codec.encode_batch(hidden)
        logits = model.server_forward(server_p, codec.decode_batch(payload),
                                      last_only=True)
    x, _, _ = ref.run_layers(config, inputs, ref.embed(config, inputs, tok),
                             0, 2, block=B)
    codes, scale, zero = ref.quantise(x)
    assert (payload["data"].int() - codes.int()).abs().max() <= 1
    y, _, _ = ref.run_layers(config, inputs,
                             ref.dequantise(payload["data"],
                                            payload["scale"],
                                            payload["zero"]), 2, 3, block=B)
    want = ref.head(config, inputs, y, lambda t: t.float())
    assert rel_gap(logits[:, 0], want) <= LOGIT_TOL


def test_decode_through_the_latent_cache_matches_the_forward():
    """Prefill of 8 tokens by decode steps, then 8 more steps, through the
    latent cache (576 values a token a layer at published widths; here
    kv_lora_rank + qk_rope_head_dim = 40), against the reference's full
    forward at every position."""
    config, inputs, cfg, model, tp, tok = setup(seed=9)
    cache = model.init_cache(B, S, torch.float32, device="cpu")
    assert cache["lead0_mla"]["c_kv"].shape == (B, S, 32)
    assert cache["scan"]["b0_mla"]["k_pe"].shape == (2, B, S, 8)
    t_mla.reset_counters()
    steps = []
    with torch.no_grad():
        for t in range(S):
            logits, cache = model.decode_step(tp, tok[:, t:t + 1], cache,
                                              torch.tensor(t))
            steps.append(logits)
    want = ref.forward_logits(config, inputs, tok)[0]
    assert rel_gap(torch.cat(steps, 1), want) <= LOGIT_TOL
    # every step read each layer's whole latent cache: 3 layers x 40
    # values x S positions x B, float32
    assert t_mla.mla_counters()["cache_bytes"] == S * 3 * B * S * 40 * 4


def test_training_loss_and_gradients_run():
    """Under autograd the MLA core is eager: the loss is finite and every
    projection gets a gradient."""
    r = get_config("moonlight-16b-a3b").reduced()
    model = DecoderModel(r)
    p = model.init(torch.Generator().manual_seed(1), device="cpu")
    leaves = p["lead0_mla"]["mla"]
    for t in leaves.values():
        for x in t.values():
            x.requires_grad_(True)
    tok = torch.randint(0, r.vocab, (2, 8),
                        generator=torch.Generator().manual_seed(2))
    loss, _ = model.loss(p, {"tokens": tok}, remat=False)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(x.grad is not None and x.grad.abs().sum() > 0
               for t in leaves.values() for x in t.values())


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------

def _router_case(seed=3, T=64, E=8, K=2):
    cfg = t_moe.MoEConfig(d_model=16, d_ff_expert=8, n_experts=E, top_k=K,
                          dropless=True, router="sigmoid_bias",
                          routed_scaling=2.446)
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(T, E, generator=g)
    bias = torch.randn(E, generator=g) * 0.3
    return cfg, logits, bias


def test_bias_changes_the_choice_and_never_the_gates():
    cfg, logits, bias = _router_case()
    idx, gates = t_moe._route({"e_score_correction_bias": bias}, cfg, logits)
    idx0, _ = t_moe._route({"e_score_correction_bias": bias * 0}, cfg,
                           logits)
    assert (idx.sort(1).values != idx0.sort(1).values).any(1).float() \
        .mean() > 0.2
    scores = torch.sigmoid(logits).gather(1, idx)
    want = scores / (scores.sum(-1, keepdim=True) + 1e-20) * 2.446
    torch.testing.assert_close(gates, want, rtol=0, atol=0)
    torch.testing.assert_close(gates.sum(-1), torch.full((64,), 2.446),
                               rtol=1e-6, atol=1e-6)
    # the choice is the top-k of scores + bias, in descending order
    key = torch.sigmoid(logits) + bias
    assert torch.equal(idx, torch.topk(key, 2).indices)


def test_capacity_route_refuses_the_sigmoid_router():
    cfg, _, _ = _router_case()
    x = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="dropless"):
        t_moe.moe_apply({}, dataclasses.replace(cfg, dropless=False), x)
    with pytest.raises(ValueError, match="unknown router"):
        t_moe.moe_apply({}, dataclasses.replace(cfg, router="top1"), x)


def test_moe_config_carries_the_router():
    m = moe_config(get_config("moonlight-16b-a3b"))
    assert (m.router, m.routed_scaling, m.dropless) == \
        ("sigmoid_bias", 2.446, True)
    assert m.PORT_ONLY[-2:] == ("router", "routed_scaling")


# ---------------------------------------------------------------------------
# K5 with values narrower than the keys, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_with_narrow_values_matches_an_explicit_softmax(
        causal):
    g = torch.Generator().manual_seed(4)
    Bq, H, Sq, D, Dv = 2, 3, 10, 24, 8
    q, k = (torch.randn(Bq, H, Sq, D, generator=g) for _ in range(2))
    v = torch.randn(Bq, H, Sq, Dv, generator=g)
    got = attention_ref(q, k, v, causal=causal)
    s = (q @ k.transpose(-1, -2)) * D ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(Sq, Sq, dtype=torch.bool).tril(),
                          float("-inf"))
    want = torch.softmax(s, -1) @ v
    assert got.shape == (Bq, H, Sq, Dv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_flash_wrapper_takes_narrow_values_in_bf16_alone():
    bf = torch.bfloat16
    q = torch.randn(1, 2, 16, 192).to(bf)
    v = torch.randn(1, 2, 16, 128).to(bf)
    got = flash_attention(q, q, v)
    assert got.shape == (1, 2, 16, 128)
    assert tensor_core_route(bf, 192, 128)
    assert not tensor_core_route(bf, 192) and not tensor_core_route(
        torch.float32, 192, 128)
    # the CPU's plain version computes any pair; the kernel's checks (on
    # meta, as on CUDA) refuse what its tensor-core route does not take
    f = flash_attention(q.float(), q.float(), v.float())
    torch.testing.assert_close(
        f, attention_ref(q.float(), q.float(), v.float()))
    qm, vm = q.to("meta"), v.to("meta")
    assert flash_attention(qm, qm, vm).shape == (1, 2, 16, 128)
    with pytest.raises(ValueError, match="tensor-core route"):
        flash_attention(qm.float(), qm.float(), vm.float())
    wide = torch.zeros(1, 2, 16, 200, dtype=bf, device="meta")
    with pytest.raises(ValueError, match="tensor-core route"):
        flash_attention(wide, wide, vm)
    with pytest.raises(ValueError, match="tensor-core route"):
        flash_attention(qm, qm, torch.zeros(1, 2, 16, 136, dtype=bf,
                                            device="meta"))


@pytest.mark.parametrize("grad", [False, True])
def test_mla_core_leaves_k5_only_under_autograd(grad):
    """A float32 MLA layer without autograd reaches K5, which refuses it
    where the kernel runs (meta here, as on CUDA): nothing goes around the
    refusal.  Under autograd the core is K5's plain version in float32."""
    m = mla_config(get_config("moonlight-16b-a3b").reduced())
    p = t_mla.mla_init(torch.Generator().manual_seed(0), m, device="cpu")
    p = tree_map(lambda t: t.to("meta").requires_grad_(grad), p)
    x = torch.empty((1, 16, m.d_model), device="meta")
    if grad:
        assert t_mla.mla_attention(p, m, x).shape == x.shape
    else:
        with pytest.raises(ValueError, match="tensor-core route"):
            t_mla.mla_attention(p, m, x)


def test_attention_flops_count_both_widths():
    assert attention_flops(1, 16, 8, 8, 192, causal=True, v_dim=128) == \
        2 * 16 * (192 + 128) * 36
    assert attention_flops(2, 4, 8, 8, 64, causal=False) == \
        attention_flops(2, 4, 8, 8, 64, causal=False, v_dim=64)
