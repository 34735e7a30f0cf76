"""Plain reference of one Moonlight-16B-A3B prefill decision split at a
layer boundary, and the comparison that decides a run's ``correct``.

Written from the published description alone (the model's config.json,
whose keys the configuration file copies, ``model_type`` deepseek_v3, and
transformers' DeepSeek-V3 equations); it imports nothing of the program.
One decision is a prompt of ``seq_len`` token ids and its next-token
logits at the last position:

1. the edge: the token embeddings, then the first ``edge_layers`` layers;
2. the wire codec: per-example affine quantisation of the boundary hidden
   to uint8, and its inverse (``bench/reference/hybrid_lm.py``'s);
3. the server: the other layers, the final RMSNorm, and the untied head
   (``lm_head``) at the last position.

A layer is ``x += attn(norm1(x))``, then ``x += ffn(norm2(x))``:

* attention, multi-head latent (no query LoRA): ``q = x Wq`` as
  ``num_attention_heads`` heads of ``qk_nope_head_dim + qk_rope_head_dim``;
  ``x W_kv_a`` split into a latent of ``kv_lora_rank`` (RMSNorm'd) and one
  key part ``k_pe`` of ``qk_rope_head_dim`` shared by every head; the latent
  times ``W_kv_b`` gives each head's ``k_nope`` and value
  (``qk_nope_head_dim``, ``v_head_dim``); RoPE (theta ``rope_theta``) on
  each head's ``q_pe`` and on ``k_pe`` in transformers' interleaved form
  (``rope_interleave``); the query [q_nope, q_pe] against the key [k_nope,
  k_pe], scaled by ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``,
  causal, softmax, times the values; ``o_proj``.  Computed a block of
  ``ATTN_BLOCK`` queries at a time, so that 8,192 tokens fit.
* the FFN: in the first ``first_k_dense_replace`` layers a SwiGLU of width
  ``intermediate_size``; after them the MoE: the router's logits (no bias),
  ``scores = sigmoid(logits)``, each token's experts the top
  ``num_experts_per_tok`` of ``scores + e_score_correction_bias`` (one
  group: ``n_group`` = ``topk_group`` = 1), its gates the chosen scores
  over their sum (+ 1e-20, ``norm_topk_prob``) times
  ``routed_scaling_factor``; each expert a SwiGLU of width
  ``moe_intermediate_size``, run by a loop over the experts on the rows
  routed to it; nothing dropped; plus the shared experts, one ungated
  SwiGLU of width ``n_shared_experts * moe_intermediate_size``.

Everything computes in float32 with TF32 off, one layer's weights cast to
float32 at a time.  ``precision="fp8"`` is the control (every matrix
product's operands rounded to fp8 e4m3, per-tensor scaled), and
``precision="bf16"`` the reading of what the stated precision alone moves
(operands and the residual stream rounded to bf16), as in
``hybrid_lm.py``; the norms, the softmax, the router's sigmoid and the
RoPE stay float32.

Departures from the published model, each a choice of this benchmark:

* weights are random (``make_inputs``): bf16 fan-in normal matrices
  (embedding std ``hidden_size ** -0.5``); RMSNorm scales ``1 + 0.1 N(0,
  1)``; the router's values bf16's, held in float32; the correction bias
  float32 ``BIAS_STD N(0, 1)``, non-zero so that it moves the choice;
* where the program's routes are given (``judge``), a layer computes the
  experts the program chose, with the reference's own gates, and each
  (token, layer) whose chosen set trails the reference's own order (of
  ``scores + bias``) by more than rounding explains (``ROUTE_MARGIN`` of
  the token's spread of that sum) counts in ``route_flips``.

The benchmark draws the weights and the pool of token ids here, from the
seed, on the device, and hands the same tensors to the program and to the
reference.
"""
from __future__ import annotations

import torch

from bench.reference.hybrid_lm import (_draw, _operands, _tf32_off,
                                       dequantise, quantise, rmsnorm, swiglu,
                                       to_fp8)

# query rows a block of the reference's attention: 16 heads x 1,024 x 8,192
# float32 scores take 512 MiB
ATTN_BLOCK = 1024
# std of the drawn e_score_correction_bias, in the sigmoid scores' units:
# their spread over the experts is about 0.21 at the cell's widths, so the
# bias changes the chosen set of about two thirds of the (token, layer)
# pairs and leaves the experts' load near what the scores give
BIAS_STD = 0.03
# A (token, layer) pair's route is wrong where the program's chosen set
# trails the reference's own order: its weakest chosen expert's
# score + bias lies below the strongest unchosen one's by more than
# ROUTE_MARGIN times the token's spread of that sum (its standard deviation
# over the experts).  A bf16 program routes from a residual stream a few per
# cent off float32, which moves two experts' sums by a few hundredths of the
# spread, so a near tie goes either way; a router that ignores the bias, or
# picks other experts, trails by a good part of the spread.
ROUTE_MARGIN = 0.25
F32 = ("router", "bias")          # held in float32


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------

def dims(config: dict) -> dict:
    c = config
    for key, want in (("q_lora_rank", None), ("n_group", 1),
                      ("topk_group", 1), ("scoring_func", "sigmoid"),
                      ("topk_method", "noaux_tc"), ("hidden_act", "silu"),
                      ("attention_bias", False), ("moe_layer_freq", 1),
                      ("tie_word_embeddings", False)):
        if c[key] != want:
            raise ValueError(f"{c['name']}: {key} {c[key]!r}; this reference "
                             f"computes {want!r}")
    return {"D": c["hidden_size"], "H": c["num_attention_heads"],
            "r": c["kv_lora_rank"], "dn": c["qk_nope_head_dim"],
            "dr": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "Fd": c["intermediate_size"], "F": c["moe_intermediate_size"],
            "Fs": c["n_shared_experts"] * c["moe_intermediate_size"],
            "E": c["n_routed_experts"], "K": c["num_experts_per_tok"],
            "V": c["vocab_size"], "eps": c["rms_norm_eps"],
            "dense": c["first_k_dense_replace"]}


def shapes(config: dict, dense: bool) -> dict:
    """Each weight of one layer: (shape, its kind of draw)."""
    d = dims(config)
    D, H = d["D"], d["H"]
    attn = {"norm1": ((D,), "norm"),
            "wq": ((D, H * (d["dn"] + d["dr"])), "fan_in"),
            "wkv_a": ((D, d["r"] + d["dr"]), "fan_in"),
            "kv_norm": ((d["r"],), "norm"),
            "wkv_b": ((d["r"], H * (d["dn"] + d["dv"])), "fan_in"),
            "wo": ((H * d["dv"], D), "fan_in"), "norm2": ((D,), "norm")}
    if dense:
        return {**attn, "gate": ((D, d["Fd"]), "fan_in"),
                "up": ((D, d["Fd"]), "fan_in"), "down": ((d["Fd"], D),
                                                         "fan_in")}
    E, F_, Fs = d["E"], d["F"], d["Fs"]
    return {**attn, "router": ((D, E), "router"), "bias": ((E,), "bias"),
            "w_gate": ((E, D, F_), "expert"), "w_up": ((E, D, F_), "expert"),
            "w_down": ((E, F_, D), "expert"), "s_gate": ((D, Fs), "fan_in"),
            "s_up": ((D, Fs), "fan_in"), "s_down": ((Fs, D), "fan_in")}


# ---------------------------------------------------------------------------
# Inputs, from the seed
# ---------------------------------------------------------------------------

def _fill(out: torch.Tensor, how: str, gen) -> None:
    if how == "bias":
        out.normal_(0.0, BIAS_STD, generator=gen)
    else:
        _draw(out, how, gen)


def make_inputs(config: dict, params: dict, seed: int, device) -> dict:
    """Weights and the pool of tick batches for ``seed``, drawn on
    ``device`` by one generator.

    The first ``first_k_dense_replace`` layers' weights lie in ``lead``
    (one dict a layer); the MoE layers' are drawn into one tensor a
    weight, stacked over the layers (``stack[name]``, leading axis the
    layer), so that the program can take them without a copy;
    ``layers[i]`` holds layer i's weights (views of the stack after the
    lead).  The pool is ``pool_batches`` batches of ``frames_per_tick``
    prompts of ``seq_len`` token ids, uniform over the vocabulary."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**64)
    d = dims(config)
    n, lead_n = config["num_hidden_layers"], d["dense"]
    embed = torch.empty((d["V"], d["D"]), dtype=torch.bfloat16, device=dev)
    embed.normal_(0.0, d["D"] ** -0.5, generator=gen)

    def empty(shape, how, lead=()):
        return torch.empty(lead + shape, dtype=torch.float32 if how in F32
                           else torch.bfloat16, device=dev)

    lead = [{name: empty(shape, how) for name, (shape, how)
             in shapes(config, True).items()} for _ in range(lead_n)]
    stack = {name: empty(shape, how, (n - lead_n,))
             for name, (shape, how) in shapes(config, False).items()}
    layers = []
    for i in range(n):
        dense = i < lead_n
        w = lead[i] if dense else {k: t[i - lead_n] for k, t in stack.items()}
        for name, (_, how) in shapes(config, dense).items():
            _fill(w[name], how, gen)
        layers.append(w)
    final_norm = torch.empty((d["D"],), dtype=torch.bfloat16, device=dev)
    _draw(final_norm, "norm", gen)
    lm_head = torch.empty((d["D"], d["V"]), dtype=torch.bfloat16, device=dev)
    _draw(lm_head, "fan_in", gen)
    tokens = torch.randint(0, d["V"], (params["pool_batches"],
                                       params["frames_per_tick"],
                                       params["seq_len"]),
                           generator=gen, device=dev)
    return {"embed": embed, "final_norm": final_norm, "lm_head": lm_head,
            "lead": lead, "stack": stack, "layers": layers,
            "tokens": tokens}


# ---------------------------------------------------------------------------
# The decision, plainly
# ---------------------------------------------------------------------------

def rope(x, theta: float):
    """transformers' interleaved RoPE on x (b, h, S, d) at positions 0 ..
    S - 1: the pairs (2i, 2i + 1) gathered into halves, then the
    rotate-half form with frequencies theta ** (-2i / d), in float32."""
    b, h, S, d = x.shape
    x = x.view(b, h, S, d // 2, 2).transpose(4, 3).reshape(b, h, S, d)
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    freqs = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    emb = torch.cat((freqs, freqs), -1)
    cos, sin = emb.cos(), emb.sin()
    rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), -1)
    return x * cos + rot * sin


def attention(config: dict, w: dict, u, rnd):
    """Multi-head latent attention, causal, on u (b, S, D) float32."""
    d = dims(config)
    b, S, _ = u.shape
    H, r, dn, dr, dv = d["H"], d["r"], d["dn"], d["dr"], d["dv"]
    x = rnd(u)
    q = (x @ rnd(w["wq"])).view(b, S, H, dn + dr).transpose(1, 2)
    ckv = x @ rnd(w["wkv_a"])
    c = rmsnorm(ckv[..., :r], w["kv_norm"], d["eps"])
    kv = (rnd(c) @ rnd(w["wkv_b"])).view(b, S, H, dn + dv).transpose(1, 2)
    theta = config["rope_theta"]
    q_pe = rope(q[..., dn:], theta)
    k_pe = rope(ckv[..., r:].reshape(b, 1, S, dr), theta)
    q = torch.cat((q[..., :dn], q_pe), -1)
    k = torch.cat((kv[..., :dn], k_pe.expand(b, H, S, dr)), -1)
    v = kv[..., dn:]
    scale = (dn + dr) ** -0.5
    kr, vr = rnd(k).transpose(-1, -2), rnd(v)
    o = torch.empty((b, H, S, dv), dtype=torch.float32, device=u.device)
    for q0 in range(0, S, ATTN_BLOCK):
        q1 = min(q0 + ATTN_BLOCK, S)
        s = (rnd(q[:, :, q0:q1]) @ kr[..., :q1]) * scale
        mask = (torch.arange(q1, device=u.device)[None, :]
                <= torch.arange(q0, q1, device=u.device)[:, None])
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
        o[:, :, q0:q1] = rnd(p) @ vr[:, :, :q1]
    return rnd(o.transpose(1, 2).reshape(b, S, H * dv)) @ rnd(w["wo"])


def route_key(w: dict, logits):
    """(scores, the sum the choice is made on: scores + the bias)."""
    scores = torch.sigmoid(logits)
    return scores, scores + w["bias"]


def moe(config: dict, w: dict, u, rnd, routes=None):
    """The routed experts and the shared experts on u (b, S, D).  Returns
    (y, own top-k ids (b S, K), route): with ``routes`` (b S, K) the
    program's expert ids, the experts computed are those, and ``route`` is
    (tokens whose own top-k set differs from them, tokens whose chosen set
    trails the own order by more than ``ROUTE_MARGIN``, the widest trail),
    the trail being the strongest unchosen expert's score + bias less the
    weakest chosen one's, over the token's spread of that sum."""
    d = dims(config)
    K = d["K"]
    x = u.reshape(-1, d["D"])
    logits = rnd(x) @ rnd(w["router"])
    scores, key = route_key(w, logits)
    own = torch.topk(key, K, dim=-1).indices
    route = (0, 0, 0.0)
    use = own
    if routes is not None:
        use = routes.to(own.device, torch.int64)
        chosen = torch.zeros_like(key, dtype=torch.bool).scatter_(1, use, True)
        trail = ((key.masked_fill(chosen, float("-inf")).amax(1)
                  - key.masked_fill(~chosen, float("inf")).amin(1))
                 / key.std(1).clamp(min=1e-30))
        route = (int((trail > 0).sum()), int((trail > ROUTE_MARGIN).sum()),
                 float(trail.amax()))
    g = scores.gather(1, use)
    if config["norm_topk_prob"]:
        g = g / (g.sum(-1, keepdim=True) + 1e-20)
    gates = g * config["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(d["E"]):
        tok, slot = torch.nonzero(use == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(x[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e], rnd)
        y.index_add_(0, tok, h * gates[tok, slot][:, None])
    y = y + swiglu(x, w["s_gate"], w["s_up"], w["s_down"], rnd)
    return y.reshape(u.shape), own, route


def layer(config: dict, w: dict, dense: bool, x, rnd, routes=None,
          res=None):
    """One layer on x (b, S, D) float32; ``w`` already float32; ``res``
    rounds the residual stream after each add (None: float32).  Returns
    (x, own top-k ids or None, route)."""
    eps = config["rms_norm_eps"]
    res = res or (lambda t: t)
    x = res(x + attention(config, w, rmsnorm(x, w["norm1"], eps), rnd))
    h = rmsnorm(x, w["norm2"], eps)
    if dense:
        return res(x + swiglu(h, w["gate"], w["up"], w["down"], rnd)), \
            None, (0, 0, 0.0)
    y, own, route = moe(config, w, h, rnd, routes)
    return res(x + y), own, route


def _f32(w: dict) -> dict:
    return {k: v.float() for k, v in w.items()}


def run_layers(config: dict, inputs: dict, x, lo: int, hi: int,
               precision="float32", routes=None, block: int = 1):
    """Layers [lo, hi) on x (B, S, D), in blocks of ``block`` prompts,
    each layer's weights cast to float32 once a block.  ``routes``: the
    program's expert ids of each MoE layer, (MoE layers, B S, K), the
    first for layer ``first_k_dense_replace``, or None.  Returns (x, own
    ids (the MoE layers of [lo, hi), B S, K) or None, route): :func:`moe`'s
    counts summed over the layers and blocks, its widest trail the
    widest."""
    rnd = _operands(precision)
    res = _operands(precision) if precision == "bf16" else None
    lead_n = config["first_k_dense_replace"]
    B, S, _ = x.shape
    outs, owns, route = [], [], (0, 0, float("-inf"))
    with _tf32_off():
        for b0 in range(0, B, block):
            h = x[b0:b0 + block].float()
            rows = slice(b0 * S, (b0 + h.shape[0]) * S)
            own_b = []
            for i in range(lo, hi):
                dense = i < lead_n
                r = (None if routes is None or dense
                     else routes[i - lead_n][rows])
                h, own, f = layer(config, _f32(inputs["layers"][i]), dense,
                                  h, rnd, r, res)
                if own is not None:
                    own_b.append(own)
                route = (route[0] + f[0], route[1] + f[1],
                         max(route[2], f[2]))
            outs.append(h)
            owns.append(torch.stack(own_b) if own_b else None)
    own = torch.cat(owns, 1) if owns and owns[0] is not None else None
    return torch.cat(outs), own, route


def embed(config: dict, inputs: dict, tokens):
    return inputs["embed"][tokens].float()


def head(config: dict, inputs: dict, x, rnd):
    """Logits (B, V) at the last position of x (B, S, D), through the
    untied ``lm_head``."""
    h = rmsnorm(x[:, -1], inputs["final_norm"], config["rms_norm_eps"])
    with _tf32_off():
        return rnd(h) @ rnd(inputs["lm_head"])


def decide(config: dict, inputs: dict, tokens, precision="float32",
           block: int = 1) -> dict:
    """A whole decision for a batch of prompts, with the reference's own
    routing: what the program's edge and server return, as a sample of
    ``judge`` holds it (on the host)."""
    n, e = config["num_hidden_layers"], config["edge_layers"]
    x, own_e, _ = run_layers(config, inputs, embed(config, inputs, tokens),
                             0, e, precision, block=block)
    codes, scale, zero = quantise(x)
    y, own_s, _ = run_layers(config, inputs, dequantise(codes, scale, zero),
                             e, n, precision, block=block)
    logits = head(config, inputs, y, _operands(precision))
    routes = torch.cat([o for o in (own_e, own_s) if o is not None]) \
        .to(torch.uint8)
    return {"codes": codes.cpu(), "scale": scale.cpu(), "zero": zero.cpu(),
            "logits": logits.cpu(), "routes": routes.cpu(),
            "hidden": x.cpu()}


def forward_logits(config: dict, inputs: dict, tokens,
                   precision="float32", routes=None):
    """The whole model without the wire: (B, S, V) logits at every
    position (for the tests against transformers and the decode), and
    :func:`run_layers`' route counts; ``routes`` as it takes them."""
    x, _, route = run_layers(config, inputs, embed(config, inputs, tokens),
                             0, config["num_hidden_layers"], precision,
                             routes=routes, block=tokens.shape[0])
    h = rmsnorm(x, inputs["final_norm"], config["rms_norm_eps"])
    with _tf32_off():
        rnd = _operands(precision)
        return rnd(h) @ rnd(inputs["lm_head"]), route


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def gaps(config: dict, inputs: dict, idx: int, sample: dict,
         block: int = 1) -> dict:
    """The numbers compared for one tick's answers, against the float32
    reference of pool batch ``idx``: ``hidden_gap``, ``header_gap``,
    ``logit_gap``, ``route_flips`` (with ``route_sets_differ`` and
    ``route_gap`` beside it) and ``codec_gap``, as
    ``bench/reference/hybrid_lm.py``'s ``gaps`` defines them; the routes
    are the MoE layers' (the dense layers route nothing), and a trail is
    measured on ``scores + bias`` (:func:`moe`)."""
    n, e = config["num_hidden_layers"], config["edge_layers"]
    tokens = inputs["tokens"][idx]
    dev = tokens.device
    codes, scale, zero = (sample["codes"].to(dev), sample["scale"].to(dev),
                          sample["zero"].to(dev))
    routes = sample.get("routes")
    if isinstance(routes, (list, tuple)):
        routes = torch.stack([r.to(dev) for r in routes])
    elif routes is not None:
        routes = routes.to(dev)
    feats, _, route_e = run_layers(config, inputs,
                                   embed(config, inputs, tokens), 0, e,
                                   routes=routes, block=block)
    _, s_ref, z_ref = quantise(feats)
    shape = (-1,) + (1,) * (codes.dim() - 1)
    off = (dequantise(codes, scale, zero) - feats).abs() \
        - scale.view(shape) / 2
    hidden_gap = (off / s_ref.view(shape)).amax().clamp(min=0)
    ends = torch.maximum((zero - z_ref).abs(),
                         (zero + 255 * scale - z_ref - 255 * s_ref).abs())
    header_gap = (ends / s_ref).amax()
    del feats, off
    y, _, route_s = run_layers(config, inputs,
                               dequantise(codes, scale, zero), e, n,
                               routes=routes, block=block)
    want = head(config, inputs, y, _operands("float32"))
    logit_gap = ((sample["logits"].to(dev).float() - want).abs().amax()
                 / want.abs().amax().clamp(min=1e-30))
    pairs = (n - config["first_k_dense_replace"]) * tokens.numel()
    out = {"hidden_gap": float(hidden_gap), "header_gap": float(header_gap),
           "logit_gap": float(logit_gap), "route_flips": 1.0,
           "codec_gap": float("inf"), "route_sets_differ": 1.0,
           "route_gap": float("inf")}
    if routes is not None:
        out.update(route_flips=(route_e[1] + route_s[1]) / pairs,
                   route_sets_differ=(route_e[0] + route_s[0]) / pairs,
                   route_gap=max(route_e[2], route_s[2]))
    if sample.get("hidden") is not None:
        h = sample["hidden"].to(dev).float()
        _, s_own, z_own = quantise(h)
        off = ((dequantise(codes, scale, zero) - h).abs()
               / s_own.view(shape) - 0.5).amax()
        ends = torch.maximum((zero - z_own).abs(),
                             (scale - s_own).abs() * 255) / s_own
        out["codec_gap"] = float(torch.maximum(off, ends.amax()).clamp(min=0))
    return out


def judge(config: dict, inputs: dict, kept: list, params: dict) -> dict:
    """The widest reading of each number over the kept ticks, the
    reference computed in blocks of the cell's ``reference_block``
    prompts."""
    block = params.get("reference_block", 1)
    readings: dict = {}
    for idx, sample in kept:
        for k, v in gaps(config, inputs, idx, sample, block).items():
            readings.setdefault(k, []).append(v)
    # torch's max keeps a NaN, which then fails every limit
    return {k: float(torch.tensor(v).max()) for k, v in readings.items()}


__all__ = ["ATTN_BLOCK", "BIAS_STD", "ROUTE_MARGIN", "attention", "decide",
           "dims", "embed", "forward_logits", "gaps", "head", "judge",
           "make_inputs", "moe", "rope", "route_key", "run_layers", "shapes",
           "to_fp8"]
