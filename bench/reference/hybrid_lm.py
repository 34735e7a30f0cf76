"""Plain reference of one granite-4.0-h prefill decision split at a layer
boundary, and the comparison that decides a run's ``correct``.

Written from the published description alone (the model's config.json,
whose keys the configuration file copies, and the Mamba-2 paper's SSD,
arXiv:2405.21060); it imports nothing of the program.  One decision is a
prompt of ``seq_len`` token ids and its next-token logits at the last
position:

1. the edge: the token embeddings times ``embedding_multiplier``, then
   the first ``edge_layers`` layers;
2. the wire codec: per-example affine quantisation of the boundary
   hidden to uint8 (``scale = max(hi - lo, 1e-8) / 255``, ``zero = lo``,
   codes ``round((h - lo) / scale)`` clamped to [0, 255]) and its inverse;
3. the server: the other layers, the final RMSNorm, and the tied
   embedding as the head at the last position, over ``logits_scaling``.

A layer is ``x += r * mixer(norm1(x))``, then ``x += r * (moe(norm2(x)) +
shared(norm2(x)))`` with ``r = residual_multiplier``.  The mixer is
Mamba-2 or attention, as ``layer_types`` says:

* Mamba-2: ``in_proj`` (no bias) to [z, x, B, C, dt]; a causal depthwise
  conv of width ``mamba_d_conv`` with a bias over [x, B, C], then SiLU;
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD scan
  (chunked, as the paper's minimal SSD, in chunks of
  ``mamba_chunk_size``); ``y + D x``; the gated RMSNorm ``norm(y *
  silu(z))`` over all ``mamba_expand * hidden_size`` channels (one
  group); ``out_proj``.
* attention: GQA, ``num_attention_heads`` query heads over
  ``num_key_value_heads``, no positional encoding, causal, scores times
  ``attention_multiplier``.
* the MoE: a router (no bias); each token's top ``num_experts_per_tok``
  router logits through a softmax give its gates over those experts;
  each expert a SwiGLU of width ``intermediate_size``, run by a loop over
  the experts on the rows routed to it; nothing dropped.  The shared
  expert is an ungated SwiGLU of width ``shared_intermediate_size``.

Everything computes in float32 with TF32 off, one layer's weights cast to
float32 at a time.  ``precision="fp8"`` is the control: every matrix
product's operands rounded to fp8 e4m3 (per-tensor scaled to its range,
round to nearest even), the rounding a deployment below the stated bf16
would apply; the norms, softmaxes and the SSD scan stay float32.
``precision="bf16"`` rounds the same operands, and the residual stream
after each add, to bf16 instead: what the stated precision alone moves
(a reading, not a check).

Departures from the published model, each a choice of this benchmark:

* weights are random (``make_inputs``): bf16 fan-in normal matrices;
  RMSNorm scales ``1 + 0.1 N(0, 1)``; the conv bias ``0.1 N(0, 1)``;
  ``A_log = log U(1, 16)``, ``dt_bias`` the inverse softplus of a dt
  drawn log-uniform in [1e-3, 1e-1] (Mamba-2's initialisation) and ``D``
  uniform in [0.5, 1.5]; the router's values are bf16's, held in float32;
* the depth is the configuration's ``num_hidden_layers``, the first
  layers of ``layer_types``;
* where the program's routes are given (``judge``), a layer computes the
  experts the program chose, with the reference's own gates over them, so
  that a near tie that rounding decided the other way is not read as an
  error of the hidden state or the logits; each (token, layer) whose
  chosen set trails the reference's own order by more than rounding can
  explain (``ROUTE_MARGIN``) is counted in ``route_flips``.

The benchmark draws the weights and the pool of token ids here, from the
seed, on the device, and hands the same tensors to the program and to the
reference.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

KINDS = ("mamba", "attention")


# ---------------------------------------------------------------------------
# The configuration
# ---------------------------------------------------------------------------

def layer_kinds(config: dict) -> list[str]:
    """The mixer of each layer run: the first ``num_hidden_layers`` of
    ``layer_types``."""
    kinds = config["layer_types"][:config["num_hidden_layers"]]
    if len(kinds) != config["num_hidden_layers"] or any(
            k not in KINDS for k in kinds):
        raise ValueError(f"{config['name']}: layer_types {kinds!r}")
    return kinds


def period(config: dict) -> int:
    """The shortest run of layer kinds whose repeats make the layers: the
    weights of the layers at one place of it lie in one tensor."""
    kinds = layer_kinds(config)
    n = len(kinds)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and kinds == kinds[:p] * (n // p))


def dims(config: dict) -> dict:
    c = config
    D = c["hidden_size"]
    d_in = c["mamba_expand"] * D
    return {"D": D, "H": c["num_attention_heads"],
            "KV": c["num_key_value_heads"],
            # config.json states none: hidden_size / num_attention_heads
            "hd": c.get("head_dim") or D // c["num_attention_heads"],
            "F": c["intermediate_size"],
            "Fs": c["shared_intermediate_size"], "E": c["num_local_experts"],
            "K": c["num_experts_per_tok"], "V": c["vocab_size"],
            "d_in": d_in, "N": c["mamba_d_state"], "G": c["mamba_n_groups"],
            "P": c["mamba_d_head"], "Hm": d_in // c["mamba_d_head"],
            "W": c["mamba_d_conv"], "Q": c["mamba_chunk_size"],
            "eps": c["rms_norm_eps"]}


def shapes(config: dict, kind: str) -> dict:
    """Each weight of one layer: (shape, its kind of draw)."""
    d = dims(config)
    D, F_, Fs, E = d["D"], d["F"], d["Fs"], d["E"]
    moe = {"norm2": ((D,), "norm"), "router": ((D, E), "router"),
           "w_gate": ((E, D, F_), "expert"), "w_up": ((E, D, F_), "expert"),
           "w_down": ((E, F_, D), "expert"), "s_gate": ((D, Fs), "fan_in"),
           "s_up": ((D, Fs), "fan_in"), "s_down": ((Fs, D), "fan_in")}
    if kind == "attention":
        q, kv = d["H"] * d["hd"], d["KV"] * d["hd"]
        mixer = {"wq": ((D, q), "fan_in"), "wk": ((D, kv), "fan_in"),
                 "wv": ((D, kv), "fan_in"), "wo": ((q, D), "fan_in")}
    else:
        conv = d["d_in"] + 2 * d["G"] * d["N"]
        mixer = {"in_proj": ((D, 2 * d["d_in"] + 2 * d["G"] * d["N"]
                              + d["Hm"]), "fan_in"),
                 "conv_w": ((d["W"], conv), "fan_in"),
                 "conv_b": ((conv,), "bias"), "A_log": ((d["Hm"],), "A_log"),
                 "D": ((d["Hm"],), "D"), "dt_bias": ((d["Hm"],), "dt_bias"),
                 "gate_norm": ((d["d_in"],), "norm"),
                 "out_proj": ((d["d_in"], D), "fan_in")}
    return {"norm1": ((D,), "norm"), **mixer, **moe}


# ---------------------------------------------------------------------------
# Inputs, from the seed
# ---------------------------------------------------------------------------

F32 = ("router", "A_log", "D", "dt_bias")      # held in float32

# A (token, layer) pair's route is wrong where the program's chosen set
# trails the reference's own order: its weakest chosen expert's router
# logit lies below the strongest unchosen one's.  A bf16 program routes
# from a residual stream a few per cent off float32, which moves two
# experts' logit difference by a few hundredths of the token's spread of
# router logits (their standard deviation over the experts), so a near
# tie goes either way (a tenth of the pairs at the cell's size).  A pair
# counts in ``route_flips`` only where the trail exceeds ROUTE_MARGIN
# times that spread: sound runs of the cell on an H100 trail by at most
# 0.17 of it (PERF.md, section 2), so they count no pair.  A router fault
# that picks another expert trails by about the spread itself.
ROUTE_MARGIN = 0.25


def _draw(out: torch.Tensor, how: str, gen) -> None:
    """Fill ``out`` in place as ``how`` says (module docstring)."""
    if how in ("fan_in", "expert", "router"):
        fan = out.shape[-2]
        out.normal_(0.0, fan ** -0.5, generator=gen)
        if how == "router":      # bf16's values, held in float32
            out.copy_(out.to(torch.bfloat16))
    elif how == "norm":
        out.normal_(1.0, 0.1, generator=gen)
    elif how == "bias":
        out.normal_(0.0, 0.1, generator=gen)
    elif how == "A_log":
        out.uniform_(1.0, 16.0, generator=gen).log_()
    elif how == "D":
        out.uniform_(0.5, 1.5, generator=gen)
    elif how == "dt_bias":
        dt = out.uniform_(math.log(1e-3), math.log(1e-1),
                          generator=gen).exp_()
        out.copy_(dt + torch.log(-torch.expm1(-dt)))   # softplus^-1(dt)
    else:
        raise ValueError(how)


def make_inputs(config: dict, params: dict, seed: int, device) -> dict:
    """Weights and the pool of tick batches for ``seed``, drawn on
    ``device`` by one generator.

    The weights of the layers at one place of the period (``period``)
    are drawn into one tensor a weight, stacked over the periods
    (``stacks[place][name]``, leading axis the period), so that the
    program can take them without a copy; ``layers[i]`` holds layer i's
    views of them.  The pool is ``pool_batches`` batches of
    ``frames_per_tick`` prompts of ``seq_len`` token ids, uniform over
    the vocabulary."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**64)
    d = dims(config)
    kinds = layer_kinds(config)
    p = period(config)
    n_periods = len(kinds) // p
    embed = torch.empty((d["V"], d["D"]), dtype=torch.bfloat16, device=dev)
    embed.normal_(0.0, d["D"] ** -0.5, generator=gen)
    stacks = []
    for place in range(p):
        stacks.append({
            name: torch.empty((n_periods,) + shape,
                              dtype=torch.float32 if how in F32
                              else torch.bfloat16, device=dev)
            for name, (shape, how) in shapes(config, kinds[place]).items()})
    layers = []
    for i, kind in enumerate(kinds):
        views = {name: stacks[i % p][name][i // p]
                 for name in shapes(config, kind)}
        for name, (_, how) in shapes(config, kind).items():
            _draw(views[name], how, gen)
        layers.append(views)
    final_norm = torch.empty((d["D"],), dtype=torch.bfloat16, device=dev)
    _draw(final_norm, "norm", gen)
    tokens = torch.randint(0, d["V"], (params["pool_batches"],
                                       params["frames_per_tick"],
                                       params["seq_len"]),
                           generator=gen, device=dev)
    return {"embed": embed, "final_norm": final_norm, "layers": layers,
            "stacks": stacks, "kinds": kinds, "tokens": tokens}


# ---------------------------------------------------------------------------
# The decision, plainly
# ---------------------------------------------------------------------------

def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 after scaling its largest magnitude to
    e4m3's largest (448), and scaled back: float32 values on fp8's grid."""
    amax = t.abs().amax().float().clamp(min=1e-30)
    s = amax / 448.0
    return (t.float() / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for cuBLAS and cuDNN, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _operands(precision: str):
    if precision == "float32":
        return lambda t: t.float()
    if precision == "fp8":
        return to_fp8
    if precision == "bf16":
        return lambda t: t.to(torch.bfloat16).float()
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x, w, eps: float):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def segsum(x):
    """x (..., T) -> (..., T, T): entry (i, j) the sum of x over (j, i],
    -inf above the diagonal (the paper's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    low = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    x = x.masked_fill(~low, 0.0).cumsum(-2)
    diag = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(0)
    return x.masked_fill(~diag, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD scan from a zero state: x (b, S, h, p), dt (b, S, h), A (h,),
    B and C (b, S, h, n), all float32 -> y (b, S, h, p).  The paper's
    minimal chunked form: within each chunk the quadratic (attention-like)
    term, across chunks a recurrence over the chunk states."""
    b, S, h, p = x.shape
    c = S // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (A * dt).reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # b h c l
    B = B.reshape(b, c, chunk, h, -1)
    C = C.reshape(b, c, chunk, h, -1)
    A_cs = Ad.cumsum(-1)
    L = torch.exp(segsum(Ad))                                   # b h c l l
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    decay = torch.exp(A_cs[..., -1:] - A_cs)                    # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    decay_chunk = torch.exp(segsum(F.pad(A_cs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cs))
    return (y_diag + y_off).reshape(b, S, h, p)


def ssd_scan(x, dt, A, B, C):
    """The same recurrence step by step (a check of ``ssd`` at small
    sizes): h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t."""
    b, S, h, p = x.shape
    state = torch.zeros(b, h, p, B.shape[-1], dtype=x.dtype,
                        device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)[..., None, None]
        state = state * a + (dt[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, C[:, t]))
    return torch.stack(ys, 1)


def mamba(config: dict, w: dict, u, rnd):
    """The Mamba-2 mixer on u (b, S, D) float32."""
    d = dims(config)
    b, S, _ = u.shape
    d_in, G, N, Hm, P = d["d_in"], d["G"], d["N"], d["Hm"], d["P"]
    zxbcdt = rnd(u) @ rnd(w["in_proj"])
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N:]
    kw = w["conv_w"]
    pad = F.pad(xbc, (0, 0, kw.shape[0] - 1, 0))
    xbc = F.silu(sum(pad[:, i:i + S] * kw[i] for i in range(kw.shape[0]))
                 + w["conv_b"])
    x = xbc[..., :d_in].reshape(b, S, Hm, P)
    rep = Hm // G
    Bm = xbc[..., d_in:d_in + G * N].reshape(b, S, G, N) \
        .repeat_interleave(rep, 2)
    Cm = xbc[..., d_in + G * N:].reshape(b, S, G, N).repeat_interleave(rep, 2)
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    y = ssd(x, dt, A, Bm, Cm, min(d["Q"], S)) + x * w["D"][:, None]
    y = rmsnorm(y.reshape(b, S, d_in) * F.silu(z), w["gate_norm"], d["eps"])
    return rnd(y) @ rnd(w["out_proj"])


def attention(config: dict, w: dict, u, rnd):
    """GQA without positional encoding, causal, on u (b, S, D)."""
    d = dims(config)
    b, S, _ = u.shape
    H, KV, hd = d["H"], d["KV"], d["hd"]
    x = rnd(u)
    q = (x @ rnd(w["wq"])).reshape(b, S, H, hd).transpose(1, 2)
    k = (x @ rnd(w["wk"])).reshape(b, S, KV, hd).transpose(1, 2)
    v = (x @ rnd(w["wv"])).reshape(b, S, KV, hd).transpose(1, 2)
    k = k.repeat_interleave(H // KV, 1)
    v = v.repeat_interleave(H // KV, 1)
    s = (rnd(q) @ rnd(k).transpose(-1, -2)) * config["attention_multiplier"]
    mask = torch.ones(S, S, dtype=torch.bool, device=u.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = (rnd(p) @ rnd(v)).transpose(1, 2).reshape(b, S, H * hd)
    return rnd(o) @ rnd(w["wo"])


def swiglu(x, wg, wu, wd, rnd):
    x = rnd(x)
    return rnd(F.silu(x @ rnd(wg)) * (x @ rnd(wu))) @ rnd(wd)


def moe(config: dict, w: dict, u, rnd, routes=None):
    """The routed experts and the shared expert on u (b, S, D).  Returns
    (y, own top-k ids (b S, K), route): with ``routes`` (b S, K) the
    program's expert ids, the experts computed are those, and ``route``
    is (tokens whose own top-k set differs from them, tokens whose chosen
    set trails the own order by more than ``ROUTE_MARGIN``, the widest
    trail), the trail being the strongest unchosen expert's logit less
    the weakest chosen one's, over the token's spread of logits."""
    d = dims(config)
    K = d["K"]
    x = u.reshape(-1, d["D"])
    logits = rnd(x) @ rnd(w["router"])
    own = torch.topk(logits, K, dim=-1).indices
    route = (0, 0, 0.0)
    use = own
    if routes is not None:
        use = routes.to(own.device, torch.int64)
        chosen = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            1, use, True)
        trail = ((logits.masked_fill(chosen, float("-inf")).amax(1)
                  - logits.masked_fill(~chosen, float("inf")).amin(1))
                 / logits.std(1).clamp(min=1e-30))
        route = (int((trail > 0).sum()), int((trail > ROUTE_MARGIN).sum()),
                 float(trail.amax()))
    gates = torch.softmax(logits.gather(1, use), -1)
    y = torch.zeros_like(x)
    for e in range(d["E"]):
        tok, slot = torch.nonzero(use == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(x[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e], rnd)
        y.index_add_(0, tok, h * gates[tok, slot][:, None])
    y = y + swiglu(x, w["s_gate"], w["s_up"], w["s_down"], rnd)
    return y.reshape(u.shape), own, route


def layer(config: dict, w: dict, kind: str, x, rnd, routes=None, res=None):
    """One layer on x (b, S, D) float32; ``w`` already float32; ``res``
    rounds the residual stream after each add (None: float32).  Returns
    (x, own top-k ids, route) as :func:`moe` gives them."""
    r, eps = config["residual_multiplier"], config["rms_norm_eps"]
    res = res or (lambda t: t)
    mix = mamba if kind == "mamba" else attention
    x = res(x + r * mix(config, w, rmsnorm(x, w["norm1"], eps), rnd))
    y, own, route = moe(config, w, rmsnorm(x, w["norm2"], eps), rnd, routes)
    return res(x + r * y), own, route


def _f32(w: dict) -> dict:
    return {k: v.float() for k, v in w.items()}


def run_layers(config: dict, inputs: dict, x, lo: int, hi: int,
               precision="float32", routes=None, block: int = 1):
    """Layers [lo, hi) on x (B, S, D), in blocks of ``block`` prompts,
    each layer's weights cast to float32 once a block.  ``routes``: the
    program's expert ids of each layer, (layers, B S, K), or None.
    Returns (x, own ids (hi - lo, B S, K), route): :func:`moe`'s counts
    summed over the layers and blocks, its widest trail the widest."""
    rnd = _operands(precision)
    res = _operands(precision) if precision == "bf16" else None
    B, S, _ = x.shape
    outs, owns, route = [], [], (0, 0, float("-inf"))
    with _tf32_off():
        for b0 in range(0, B, block):
            h = x[b0:b0 + block].float()
            rows = slice(b0 * S, (b0 + h.shape[0]) * S)
            own_b = []
            for i in range(lo, hi):
                r = None if routes is None else routes[i][rows]
                h, own, f = layer(config, _f32(inputs["layers"][i]),
                                  inputs["kinds"][i], h, rnd, r, res)
                own_b.append(own)
                route = (route[0] + f[0], route[1] + f[1],
                         max(route[2], f[2]))
            outs.append(h)
            owns.append(torch.stack(own_b) if own_b else None)
    own = torch.cat(owns, 1) if owns and owns[0] is not None else None
    return torch.cat(outs), own, route


def embed(config: dict, inputs: dict, tokens):
    return inputs["embed"][tokens].float() * config["embedding_multiplier"]


def head(config: dict, inputs: dict, x, rnd):
    """Logits (B, V) at the last position of x (B, S, D)."""
    h = rmsnorm(x[:, -1], inputs["final_norm"], config["rms_norm_eps"])
    with _tf32_off():
        return (rnd(h) @ rnd(inputs["embed"]).T) \
            / config["logits_scaling"]


def quantise(f):
    """Per-example affine uint8 codes of ``f`` (B, ...): (codes, scale,
    zero)."""
    flat = f.reshape(f.shape[0], -1)
    lo, hi = flat.amin(1), flat.amax(1)
    scale = torch.clamp(hi - lo, min=1e-8) / 255.0
    shape = (-1,) + (1,) * (f.dim() - 1)
    q = torch.round((f - lo.view(shape)) / scale.view(shape))
    return torch.clamp(q, 0, 255).to(torch.uint8), scale, lo


def dequantise(codes, scale, zero):
    shape = (-1,) + (1,) * (codes.dim() - 1)
    return codes.to(torch.float32) * scale.view(shape) + zero.view(shape)


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
    routes = torch.cat([own_e, own_s]).to(torch.uint8)
    return {"codes": codes.cpu(), "scale": scale.cpu(), "zero": zero.cpu(),
            "logits": logits.cpu(), "routes": routes.cpu(),
            "hidden": x.cpu()}


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def gaps(config: dict, inputs: dict, idx: int, sample: dict,
         block: int = 1) -> dict:
    """The numbers compared for one tick's answers, against the float32
    reference of pool batch ``idx``.

    ``sample``: the tick's payload (``codes`` (B, S, D), ``scale``,
    ``zero``), last-position ``logits`` (B, V) and ``routes`` (layers,
    B S, K; or a list of the layers' (B S, K)), as produced, on the host
    or the device.

    * ``hidden_gap``: the widest amount, in the reference's quantisation
      steps, by which a served code's value lies off the reference's
      boundary hidden beyond the half step that rounding allows.
    * ``header_gap``: the widest shift of a prompt's range ends (``zero``
      and ``zero + 255 scale``) from the reference's, in steps.
    * ``logit_gap``: the widest gap between the served logits and the
      reference server's on the same payload, over the largest reference
      logit's magnitude.
    * ``route_flips``: the share of (token, layer) pairs whose chosen
      expert set trails the reference's own order by more than
      ``ROUTE_MARGIN`` of the token's spread of router logits (``moe``).
      Two readings beside it, held to no limit: ``route_sets_differ``,
      the share whose set differs at all (near ties included), and
      ``route_gap``, the widest trail in that unit.
    * ``codec_gap``: the wire alone: the widest amount, in the payload's
      own steps, by which a served code lies off the program's own
      boundary hidden (``hidden``, kept from the same tick) beyond the half
      step, or a range end off that hidden's, through this file's codec.
      The program's hidden is bf16, so ``hidden_gap`` carries bf16's own
      spread of a few steps; this number is exact, and a code moved
      between the edge and the server reads its move.
    """
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
    pairs = n * tokens.numel()
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


__all__ = ["ROUTE_MARGIN", "decide", "dequantise", "dims", "gaps", "judge", "layer_kinds",
           "make_inputs", "period", "quantise", "run_layers", "shapes",
           "ssd", "ssd_scan", "to_fp8"]
