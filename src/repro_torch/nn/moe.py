"""Mixture-of-Experts layer with capacity-based dispatch, as in
``repro.nn.moe``.

Expert weights are stacked on a leading expert axis, and the experts run
as one batched SwiGLU over that axis (``torch.bmm``).  Tokens are routed
in groups of ``group_size``, each expert taking at most ``C`` tokens of a
group; the rest are dropped, exactly as the reference drops them.  The
reference's sharding constraints act only under a mesh, so the port has
none: ``expert_parallel`` is carried and acts nowhere yet.

Supports the two assigned MoE archs:
  * llama4-scout : 16 routed experts, top-1, + 1 shared expert (every layer)
  * qwen2-moe    : 60 routed experts, top-4, + 4 shared experts (fused as one
                   dense SwiGLU with 4x expert width) and a shared-expert gate
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import dense, dense_init, swiglu, swiglu_init
from repro_torch.nn.module import fan_in_init


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
    # the reference's expert-parallel layout under a mesh; no mesh here
    expert_parallel: bool = False
    # run dispatch/combine in the activation dtype instead of f32
    dispatch_bf16: bool = False

    @property
    def n_experts_padded(self) -> int:
        return max(self.pad_experts_to, self.n_experts)


def moe_init(gen: torch.Generator, cfg: MoEConfig, *, dtype=torch.float32,
             device: DeviceLike = None):
    """The router (f32), the experts' SwiGLU weights stacked on a leading
    ``(E,)`` axis, and the shared expert with its gate when configured."""
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
        p["shared"] = swiglu_init(gen, D, Fd * cfg.n_shared_experts,
                                  dtype=dtype, device=dev)
        if cfg.shared_expert_gate:
            p["shared_gate"] = dense_init(gen, D, 1, dtype=dtype, device=dev)
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
    g = F.silu(torch.bmm(x, p["gate"]["kernel"]))
    return torch.bmm(g * torch.bmm(x, p["up"]["kernel"]),
                     p["down"]["kernel"])


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
    pair found a slot, and ``probs`` (n, G, E).
    """
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts_padded, cfg.top_k
    G = _group_size(cfg, T)
    n_groups = T // G
    C = _capacity(cfg, G)
    xt = x.reshape(n_groups, G, D)

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

    expert_in = torch.einsum("ngec,ngd->necd", dispatch,
                             xt.to(ddt)).to(x.dtype)
    # the experts as one batched SwiGLU, (n, C) the rows of each
    rows = expert_in.transpose(0, 1).reshape(E, n_groups * C, D)
    expert_out = _experts(params["experts"], rows) \
        .reshape(E, n_groups, C, D).transpose(0, 1)           # (n,E,C,D)
    y = torch.einsum("ngec,necd->ngd", combine.to(ddt),
                     expert_out.to(ddt)).to(x.dtype)

    if "shared" in params:
        shared = swiglu(params["shared"], xt)
        if "shared_gate" in params:
            shared = shared * torch.sigmoid(dense(params["shared_gate"], xt))
        y = y + shared

    # --- auxiliary load-balance loss (Switch-style) ------------------------
    frac_tokens = onehot.sum(2).mean(dim=(0, 1))              # (E,)
    frac_probs = probs.mean(dim=(0, 1))                       # (E,)
    aux_loss = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    entropy = -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), -1))
    return y.reshape(B, S, D), {"moe_aux_loss": aux_loss,
                                "router_entropy": entropy,
                                "expert_idx": expert_idx.detach(),
                                "keep": keep.any(-1),
                                "probs": probs.detach()}


__all__ = ["MoEConfig", "moe_apply", "moe_init"]
