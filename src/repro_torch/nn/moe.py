"""Mixture-of-Experts layer with capacity-based dispatch, as in
``repro.nn.moe``.

Expert weights are stacked on a leading expert axis, and the experts run
as one batched SwiGLU over that axis (``torch.bmm``).  Tokens are routed
in groups of ``group_size``, each expert taking at most ``C`` tokens of a
group; the rest are dropped, exactly as the reference drops them.  The
reference's constraints stand at its places (``nn.constrain.constrain``;
with ``expert_parallel``, groups over "data", experts over "model").  On
DTensors the layer runs on each chip's block of groups
(:func:`_moe_sharded`), where ``expert_parallel`` splits the experts over
"model" (each chip computes its experts' slots) and its absence splits
their FFN width.

Supports the two assigned MoE archs:
  * llama4-scout : 16 routed experts, top-1, + 1 shared expert (every layer)
  * qwen2-moe    : 60 routed experts, top-4, + 4 shared experts (fused as one
                   dense SwiGLU with 4x expert width) and a shared-expert gate

and, with ``dropless``, granite-4.0-h's layer (:func:`_moe_dropless`): 72
experts, top-10 by a softmax over the top-10 router logits, every (token,
k) pair computed; and, with ``router="sigmoid_bias"``, DeepSeek-V3's
(Moonlight-16B-A3B: 64 experts, top-6): sigmoid scores, the top-k chosen by
score plus a per-expert correction bias, the chosen unbiased scores
renormalised and scaled as gates.  The pairs are sorted by expert and K7
(``kernels.moe_grouped``) runs each expert's SwiGLU over its contiguous
rows; K9 (``kernels.moe_combine``) gathers each token's rows back and
sums them with the shared expert's.  Nothing drops and no expert computes
a row it was not given.  Its spans (``repro_torch.tracing``):
``moe.route``, ``moe.permute``, ``moe.experts`` (K7), ``moe.shared`` and
``moe.combine`` (K9); its counters: ``routed_rows`` and
``max_expert_rows`` (:func:`dropless_counters`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import ClassVar, Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.moe_combine import moe_combine
from repro_torch.kernels.moe_grouped import moe_grouped
from repro_torch.nn.constrain import (axis_sizes, constrain, data_axes,
                                      gathered, is_dtensor, on_local_tensors,
                                      on_mesh, reduced)
from repro_torch.nn.layers import dense, dense_init, swiglu, swiglu_init
from repro_torch.nn.module import (fan_in_init, tree_leaves, tree_paths,
                                   tree_unflatten)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared_experts: int = 0       # fused into one SwiGLU of n_shared * d_ff
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    shared_expert_gate: bool = False  # qwen2-moe gates the shared expert
    # capacity applies per group of tokens, so the dispatch and combine
    # tensors stay linear in the token count: (n_groups, G, E, C) with
    # C = O(K * G / E)
    group_size: int = 512
    # pad the expert axis to this count (0 = off); padded experts get
    # -inf router logits and are never selected
    pad_experts_to: int = 0
    # expert parallelism under a mesh: groups over "data", experts over
    # "model" (acts inside activation_sharding only)
    expert_parallel: bool = False
    # run dispatch/combine in the activation dtype instead of f32
    dispatch_bf16: bool = False
    # the shared experts' width where it is not n_shared * d_ff_expert
    d_ff_shared: int = 0
    # route every (token, k) pair (no capacity, no groups):
    # :func:`_moe_dropless`
    dropless: bool = False
    # the dropless route's router (:func:`_route`): "softmax" or
    # "sigmoid_bias", whose gates sum to ``routed_scaling``
    router: str = "softmax"
    routed_scaling: float = 1.0

    # fields the JAX package's dataclass lacks
    # (``models.config.port_only_dict``)
    PORT_ONLY: ClassVar[tuple] = ("d_ff_shared", "dropless", "router",
                                  "routed_scaling")

    @property
    def n_experts_padded(self) -> int:
        return max(self.pad_experts_to, self.n_experts)


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, dtype=torch.float32,
             device: DeviceLike = None):
    """The router (f32), the experts' SwiGLU weights stacked on a leading
    ``(E,)`` axis, the shared expert with its gate when configured, and
    the sigmoid router's f32 ``e_score_correction_bias`` (zeros, as
    transformers initialises it)."""
    dev = resolve_device(device)
    E, D, Fd = cfg.n_experts_padded, cfg.d_model, cfg.d_ff_expert
    stacked = fan_in_init(fan_axis=1)   # each expert's own fan-in

    def expert_stack(i, o):
        return {"kernel": stacked(gen, (E, i, o), dtype).to(dev)}

    p = {
        "router": dense_init(gen, D, E, dtype=torch.float32,
                             init=fan_in_init(), device=dev),
        "experts": {"gate": expert_stack(D, Fd), "up": expert_stack(D, Fd),
                    "down": expert_stack(Fd, D)},
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = swiglu_init(gen, D,
                                  cfg.d_ff_shared or Fd * cfg.n_shared_experts,
                                  dtype=dtype, device=dev)
        if cfg.shared_expert_gate:
            p["shared_gate"] = dense_init(gen, D, 1, dtype=dtype, device=dev)
    if cfg.router == "sigmoid_bias":
        p["e_score_correction_bias"] = torch.zeros((E,), dtype=torch.float32,
                                                   device=dev)
    return p


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(cap, cfg.top_k)


def _group_size(cfg: MoEConfig, n_tokens: int) -> int:
    g = min(cfg.group_size, n_tokens)
    while n_tokens % g:  # group size must tile the token count
        g -= 1
    return g


def _experts(p, x):
    """Every expert's SwiGLU on its own rows: x (E, T, D) -> (E, T, D)."""
    g = F.silu(torch.bmm(x, gathered(p["gate"]["kernel"])))
    return torch.bmm(g * torch.bmm(x, gathered(p["up"]["kernel"])),
                     gathered(p["down"]["kernel"]))


def moe_apply(params, cfg: MoEConfig, x, *, deterministic: bool = True,
              gen: Optional[torch.Generator] = None):
    """x: (B, S, D) -> (y, aux), aux = {"moe_aux_loss", "router_entropy",
    "expert_idx", "keep", "probs"}.

    Routing is the reference's: an f32 router, top-k of its softmax with
    the gate values renormalised, and each (token, k) pair's place in its
    expert's queue from a cumulative sum over the group's flattened
    (G·K) pairs; a pair at place C or beyond is dropped.  Dispatch and
    combine carry no gradient (the reference's ``stop_gradient``): the
    router learns through the gate values only.  ``gen`` draws the router
    jitter when ``deterministic`` is False.  The routing comes back in aux,
    detached: ``expert_idx`` (n, G, K), ``keep`` (n, G, K), whether each
    pair found a slot, and ``probs`` (n, G, E).  On DTensors each chip
    routes its own groups (:func:`_moe_sharded`).  With ``cfg.dropless``
    the layer routes by :func:`_moe_dropless` instead (one group, nothing
    dropped, ``keep`` all true), inside the span ``moe``; with gradients
    off (serving) its aux holds the routing alone.  Only the dropless route
    takes the sigmoid router (``cfg.router``); the capacity route refuses
    it.
    """
    if cfg.router not in ROUTERS:
        raise ValueError(f"unknown router {cfg.router!r}; known: {ROUTERS}")
    if cfg.router != "softmax" and not cfg.dropless:
        raise ValueError(f"the {cfg.router!r} router runs on the dropless "
                         f"route alone (MoEConfig.dropless)")
    if cfg.dropless:
        with tracing.span("moe"):
            y, stats, routing = _moe_dropless(params, cfg, x)
        if stats is None:
            return y, {"expert_idx": routing[0], "keep": routing[1]}
        return y, _aux(cfg, *stats, routing)
    if is_dtensor(x):
        return _moe_sharded(params, cfg, x, deterministic, gen)
    y, stats, routing = _moe(params, cfg, x, deterministic, gen)
    return y, _aux(cfg, *stats, routing)


def _aux(cfg: MoEConfig, frac_tokens, frac_probs, entropy, routing):
    """The Switch-style load-balance loss and the router's entropy from the
    groups' mean expert loads and probabilities."""
    expert_idx, keep, probs = routing
    return {"moe_aux_loss": cfg.n_experts * torch.sum(frac_tokens
                                                      * frac_probs),
            "router_entropy": entropy, "expert_idx": expert_idx,
            "keep": keep, "probs": probs}


def _moe(params, cfg: MoEConfig, x, deterministic, gen, e_lo: int = 0,
         shared_scale: float = 1.0):
    """The layer on plain tensors, every group of ``x`` routed over all
    the experts and computed by those in ``params["experts"]``: the
    ``e_lo``-th and the ones after it (all of them, unsharded), each with
    the width of FFN its weights hold; the shared expert's output is
    added times ``shared_scale``.  Returns (y, (the groups' mean expert
    loads, mean probabilities, mean router entropy), (expert_idx, keep,
    probs))."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts_padded, cfg.top_k
    G = _group_size(cfg, T)
    n_groups = T // G
    C = _capacity(cfg, G)
    xt = x.reshape(n_groups, G, D)
    if cfg.expert_parallel:
        # pin the group axis to "data"
        xt = constrain(xt, ("data", None, None))

    logits = dense(params["router"], xt.float())             # (n,G,E)
    if not deterministic and cfg.router_jitter > 0 and gen is not None:
        logits = logits + torch.randn(logits.shape, generator=gen,
                                      device=gen.device).to(logits.device) \
            * cfg.router_jitter
    ar_e = torch.arange(E, device=x.device)
    if E > cfg.n_experts:   # padded experts are unroutable
        logits = logits.masked_fill(ar_e >= cfg.n_experts, float("-inf"))
    probs = torch.softmax(logits, dim=-1)

    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)      # (n,G,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # --- per-group capacity dispatch ---------------------------------------
    # the routing structure is piecewise constant: the differentiable path
    # is the gate values only
    ddt = x.dtype if cfg.dispatch_bf16 else torch.float32
    onehot = (expert_idx[..., None] == ar_e).to(ddt)         # (n,G,K,E)
    # place of each (token, k) in its expert's queue, per group
    pos = torch.cumsum(onehot.reshape(n_groups, G * K, E), dim=1) \
        .reshape(n_groups, G, K, E) - onehot
    keep = (pos < C) & (onehot > 0)
    pos = (pos * onehot).sum(-1).to(torch.int32)             # (n,G,K)
    # by comparison: a dropped pair's place (>= C) matches no slot
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).to(ddt) \
        * keep.amax(-1, keepdim=True)

    disp = (onehot[..., None] * pos_oh[..., None, :]).detach()  # (n,G,K,E,C)
    dispatch = disp.sum(2)                                    # (n,G,E,C)
    combine = (disp * gate_vals[..., None, None].to(ddt)).sum(2)
    if cfg.expert_parallel:
        dispatch = constrain(dispatch, ("data", None, None, None))
        combine = constrain(combine, ("data", None, None, None))
    # the experts this call computes
    E_here = params["experts"]["gate"]["kernel"].shape[0]
    dispatch = dispatch[:, :, e_lo:e_lo + E_here]
    combine = combine[:, :, e_lo:e_lo + E_here]

    expert_in = torch.einsum("ngec,ngd->necd", dispatch,
                             xt.to(ddt)).to(x.dtype)
    if cfg.expert_parallel:
        # each model shard owns E/model_size experts
        expert_in = constrain(expert_in, ("data", "model", None, None))
    # the experts as one batched SwiGLU, (n, C) the rows of each
    rows = expert_in.transpose(0, 1).reshape(E_here, n_groups * C, D)
    expert_out = _experts(params["experts"], rows) \
        .reshape(E_here, n_groups, C, D).transpose(0, 1)      # (n,E,C,D)
    if cfg.expert_parallel:
        expert_out = constrain(expert_out, ("data", "model", None, None))
    y = torch.einsum("ngec,necd->ngd", combine.to(ddt),
                     expert_out.to(ddt)).to(x.dtype)

    if "shared" in params:
        shared = swiglu(params["shared"], xt)
        if "shared_gate" in params:
            shared = shared * torch.sigmoid(dense(params["shared_gate"], xt))
        y = y + (shared if shared_scale == 1.0 else shared * shared_scale)

    # --- auxiliary load-balance loss (Switch-style) ------------------------
    frac_tokens = onehot.sum(2).mean(dim=(0, 1))              # (E,)
    frac_probs = probs.mean(dim=(0, 1))                       # (E,)
    entropy = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), -1))
    return (y.reshape(B, S, D), (frac_tokens, frac_probs, entropy),
            (expert_idx.detach(), keep.any(-1), probs.detach()))


# the list the dropless route appends each call's expert ids to, inside
# :func:`recorded_routes`
_routes: Optional[list] = None


@contextlib.contextmanager
def recorded_routes(into: list):
    """Within the block, each dropless MoE call appends its (T, K) expert
    ids (int64, on its device, the top-k in descending order of logit) to
    ``into``, in call order."""
    global _routes
    prev, _routes = _routes, into
    try:
        yield into
    finally:
        _routes = prev


class _Counts:
    routed_rows = 0         # (token, k) pairs computed
    max_rows = None         # 0-d tensor: the most rows one expert took


def dropless_counters() -> dict:
    """What the dropless route counted since :func:`reset_counters`:
    ``routed_rows``, every (token, k) pair it computed, and
    ``max_expert_rows``, the most rows one expert took in one call (read
    from the device here, once)."""
    m = _Counts.max_rows
    return {"routed_rows": _Counts.routed_rows,
            "max_expert_rows": 0 if m is None else int(m)}


def reset_counters() -> None:
    _Counts.routed_rows, _Counts.max_rows = 0, None


ROUTERS = ("softmax", "sigmoid_bias")


def _route(params, cfg: MoEConfig, logits):
    """(expert ids (T, K), gates (T, K)) from the f32 router logits (T, E).

    ``softmax``: the top-k logits, in descending order, through a softmax.
    ``sigmoid_bias`` (DeepSeek-V3's ``noaux_tc`` with one group): scores
    ``sigmoid(logits)``; the top-k of ``scores + e_score_correction_bias``
    (the bias moves the choice alone), in descending order of that sum;
    gates the chosen unbiased scores, over their sum (+ 1e-20:
    ``norm_topk_prob``), times ``routed_scaling``."""
    K = cfg.top_k
    if cfg.router == "softmax":
        top, expert_idx = torch.topk(logits, K, dim=-1)
        return expert_idx, torch.softmax(top, dim=-1)
    scores = torch.sigmoid(logits)
    expert_idx = torch.topk(scores + params["e_score_correction_bias"], K,
                            dim=-1).indices
    gates = scores.gather(1, expert_idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return expert_idx, gates * cfg.routed_scaling


def _moe_dropless(params, cfg: MoEConfig, x):
    """The dropless layer on plain tensors: x (B, S, D) -> (y, stats,
    routing) as :func:`_moe` returns them (one group of B S tokens).

    An f32 router gives each token its k experts and gates
    (:func:`_route`: a softmax over the top-k logits, or DeepSeek-V3's
    bias-corrected sigmoid).  The (token, k) pairs are sorted by expert
    (a stable sort, so an expert's rows keep token order) and each
    expert's contiguous rows go through K7, which scales row r's output by
    its gate.  K9 sums each token's k outputs in f32, in the order k =
    0..K-1, from their sorted rows (``pos``, the sort's inverse), adds the
    shared expert's output and rounds once to x's type.  No pair is dropped.  The routing's sort and
    offsets stay on the device: nothing here waits for the card.  With
    gradients off ``stats`` is None and ``routing`` (expert_idx, keep):
    the load-balance statistics feed a training loss alone."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)
    with tracing.span("moe.route"):
        logits = dense(params["router"], xt.float())              # (T, E)
        expert_idx, gates = _route(params, cfg, logits)           # (T, K)
    if _routes is not None:
        _routes.append(expert_idx)
    with tracing.span("moe.permute"):
        sorted_e, order = torch.sort(expert_idx.reshape(-1), stable=True)
        token = order // K
        offsets = torch.searchsorted(
            sorted_e, torch.arange(E + 1, device=x.device)).to(torch.int32)
        rows = xt.index_select(0, token)
        weight = gates.reshape(-1).index_select(0, order)
        pos = torch.empty_like(order, dtype=torch.int32).scatter_(
            0, order, torch.arange(T * K, dtype=torch.int32,
                                   device=x.device))
    with tracing.span("moe.experts"):
        ex = params["experts"]
        out = moe_grouped(rows, offsets, ex["gate"]["kernel"],
                          ex["up"]["kernel"], ex["down"]["kernel"],
                          row_scale=weight)                       # f32
    shared = None
    if "shared" in params:
        with tracing.span("moe.shared"):
            shared = swiglu(params["shared"], xt)
    with tracing.span("moe.combine"):
        y = moe_combine(out, pos.view(T, K), shared, dtype=x.dtype)
    counts = offsets[1:] - offsets[:-1]
    m = counts.max()
    _Counts.routed_rows += T * K
    _Counts.max_rows = m if _Counts.max_rows is None else torch.maximum(
        _Counts.max_rows, m)
    keep = torch.ones((1, T, K), dtype=torch.bool, device=x.device)
    if not torch.is_grad_enabled():     # serving: no loss reads them
        return y.reshape(B, S, D), None, (expert_idx[None], keep)
    # the Switch-style statistics of ``_moe``, over the one group
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = counts.float() / T
    frac_probs = probs.mean(0)
    entropy = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), -1))
    return (y.reshape(B, S, D), (frac_tokens, frac_probs, entropy),
            (expert_idx[None], keep, probs[None]))


def _moe_sharded(params, cfg: MoEConfig, x, deterministic, gen):
    """The layer on DTensors, each chip on its own block (``local_map``).

    The batch is split over the data axes where each chip's tokens make
    whole groups (else every chip routes them all).  Over "model" the
    experts split by expert (with ``expert_parallel``, where the model
    axis divides them: each chip computes its experts' slots) or by FFN
    width (Megatron's split); each chip's output is then a partial sum
    over "model".  The shared expert splits by width where the model axis
    divides it, else model rank 0 alone adds it (every chip computes it,
    so that every chip's backward runs the same collectives).  The
    weights' FSDP shards are gathered on the way in.

    Every output is a sum over the chips that split the work, and so is
    the gradient of every input they all hold whole: the load and
    probability means come back as partial sums (each data shard's mean
    over its equal share of the groups, counted on model rank 0 alone
    where "model" splits the experts), summed at once, so the loss is the
    one the whole batch gives, and the gradients of the router, the replicated weights
    and ``x`` leave as partial sums over the axes that split the work."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    names = mesh.mesh_dim_names
    n_model = sizes["model"]
    B, S, D = x.shape
    E = cfg.n_experts_padded
    data = data_axes(sizes)
    n_data = math.prod(sizes[a] for a in data)
    G = _group_size(cfg, B * S)
    split_batch = B % n_data == 0 and (B // n_data * S) % G == 0
    shared = params.get("shared")
    widths = [params["experts"]["gate"]["kernel"].shape[-1]]
    if shared is not None:
        widths.append(shared["gate"]["kernel"].shape[-1])
    by_expert = cfg.expert_parallel and E % n_model == 0
    by_width = not by_expert and all(w % n_model == 0 for w in widths)
    partial = by_expert or by_width
    shared_by_width = partial and widths[-1] % n_model == 0
    # the mesh dims whose chips each do a share of the work
    split = [(name in data and split_batch) or (name == "model" and partial)
             for name in names]

    def pl(shard_dim=None, batch_dim=None):
        """Placements: ``batch_dim`` over the data axes (when the batch is
        split), ``shard_dim`` over "model"."""
        return [Shard(batch_dim) if name in data and split_batch
                and batch_dim is not None
                else Shard(shard_dim) if name == "model"
                and shard_dim is not None else Replicate()
                for name in names]

    def expert_pl(path):
        if by_expert:
            return pl(0)
        if by_width:
            return pl(1 if path.endswith("down") else 2)
        return pl()

    def weight_pl(path):
        if path.startswith("experts/"):
            return expert_pl(path.split("/")[1])
        if path.startswith("shared/") and shared_by_width:
            return pl(0 if path.split("/")[1] == "down" else 1)
        return pl()

    def grad_pl(placements):
        """A whole input's gradient is a partial sum over the dims that
        split the work; a shard's is the chip's own."""
        return [Partial() if s and p.is_replicate() else p
                for s, p in zip(split, placements)]

    paths = [p for p, _ in tree_paths(params)]
    in_pl = [pl(batch_dim=0)] + [
        weight_pl(p.rsplit("/", 1)[0]) if p.endswith("kernel") else pl()
        for p in paths]
    y_pl = [Partial() if name == "model" and partial else p
            for name, p in zip(names, pl(batch_dim=0))]
    stat_pl = [Partial() if s else Replicate() for s in split]
    route_pl = pl(batch_dim=0)

    def local(x, *leaves):
        with on_local_tensors():
            p = tree_unflatten(params, list(leaves))
            rank0 = mesh.get_local_rank("model") == 0
            e_lo = 0
            if by_expert:
                e_lo = mesh.get_local_rank("model") * (E // n_model)
            once = float(rank0 or not partial)   # 1 where it is summed once
            y, stats, routing = _moe(
                p, cfg, x, deterministic, gen, e_lo,
                shared_scale=1.0 if shared_by_width else once)
            scale = (1 / n_data if split_batch else 1.0) * once
            return (y, *(s * scale for s in stats), *routing)

    out = local_map(local, out_placements=(y_pl, stat_pl, stat_pl, stat_pl,
                                           route_pl, route_pl, route_pl),
                    in_placements=tuple(in_pl),
                    in_grad_placements=tuple(grad_pl(p) for p in in_pl),
                    device_mesh=mesh, redistribute_inputs=True)(
        x, *(on_mesh(t, mesh) for t in tree_leaves(params)))
    y, *stats, expert_idx, keep, probs = out
    # summed at once: a partial sum meeting the loss's partial mean is a
    # mix DTensor refuses to add
    return y, _aux(cfg, *map(reduced, stats), (expert_idx, keep, probs))


__all__ = ["MoEConfig", "ROUTERS", "dropless_counters", "moe_apply",
           "moe_init", "recorded_routes", "reset_counters"]
