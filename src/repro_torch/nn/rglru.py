"""RG-LRU recurrent block (RecurrentGemma / Griffin), as in
``repro.nn.rglru``.  [arXiv:2402.19427]

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a
diagonal linear recurrence.  The full sequence runs it as a log-depth
doubling scan (:func:`rglru_scan`: ⌈log₂ S⌉ steps of whole-tensor ops, no
loop over S); decode is one step.  The block is Griffin's: in-proj ->
causal conv1d(4) -> RG-LRU, gated by a GeLU branch, then out-proj.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.constrain import gathered
from repro_torch.nn.layers import dense, dense_init, gelu

_C = 8.0  # Griffin's fixed recurrence sharpness constant


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int = 0              # recurrence width; 0 => d_model
    conv_width: int = 4
    n_blocks: int = 1           # block-diagonal gate projections (Griffin uses heads)

    @property
    def width(self) -> int:
        return self.d_rnn or self.d_model


def rglru_init(gen: torch.Generator, cfg: RGLRUConfig, *,
               dtype=torch.float32, device: DeviceLike = None):
    dev = resolve_device(device)
    W = cfg.width
    # Λ initialised so a^c = exp(-c·softplus(Λ)) spans (0.9, 0.999)
    u = torch.rand((W,), generator=gen, device=gen.device) * (0.999 - 0.9) \
        + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    conv = torch.randn((cfg.conv_width, W), generator=gen,
                       device=gen.device) * 0.1
    return {
        "in_x": dense_init(gen, cfg.d_model, W, dtype=dtype, device=dev),
        "in_gate": dense_init(gen, cfg.d_model, W, dtype=dtype, device=dev),
        "conv": {"kernel": conv.to(dev, dtype),
                 "bias": torch.zeros((W,), dtype=dtype, device=dev)},
        "w_a": dense_init(gen, W, W, use_bias=True, dtype=dtype, device=dev),
        "w_i": dense_init(gen, W, W, use_bias=True, dtype=dtype, device=dev),
        "lambda": lam.to(dev, torch.float32),
        "out": dense_init(gen, W, cfg.d_model, dtype=dtype, device=dev),
    }


def _promoted_dense(p, x):
    """``dense`` in the promoted dtype of ``x`` and the weights, as jnp's
    ``x @ kernel`` computes an f32 state against bf16 weights."""
    dt = torch.promote_types(x.dtype, p["kernel"].dtype)
    y = x.to(dt) @ gathered(p["kernel"]).to(dt)
    if "bias" in p:
        y = y + p["bias"].to(dt)
    return y


def _gates(params, x):
    """x: (..., W) post-conv activations.  Returns (a, gated_input)."""
    r = torch.sigmoid(_promoted_dense(params["w_a"], x).float())
    i = torch.sigmoid(_promoted_dense(params["w_i"], x).float())
    log_a = -_C * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * x.float())


def _causal_conv(x, kernel, bias):
    W = kernel.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * kernel[i] for i in range(W))
    return out + bias


def _shift(t, s: int, fill: float):
    """``t`` moved ``s`` steps later along axis 1, ``fill`` in front."""
    return F.pad(t[:, :-s], (0, 0, s, 0), value=fill)


def rglru_scan(a, bx, h0=None):
    """Diagonal linear recurrence along axis 1: h_t = a_t h_{t-1} + bx_t.

    a, bx: (B, S, W).  A doubling (Hillis–Steele) scan: after the step of
    stride s every position holds the composition of the last 2s steps,
    so ⌈log₂ S⌉ steps of whole-tensor ops give every prefix.  The
    reference's ``associative_scan`` composes in another tree, so the two
    agree to rounding.
    """
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], 1)
    s = 1
    while s < a.shape[1]:
        # compose (a_l, b_l) then (a_r, b_r): (a_l a_r, b_l a_r + b_r)
        bx = _shift(bx, s, 0.0) * a + bx
        a = _shift(a, s, 1.0) * a
        s *= 2
    return bx


def rglru_forward(params, cfg: RGLRUConfig, u, *, h0=None,
                  return_state: bool = False):
    """Griffin recurrent block, full sequence.  u: (B, S, d_model)."""
    gate = gelu(dense(params["in_gate"], u))
    x = dense(params["in_x"], u)
    x = _causal_conv(x, params["conv"]["kernel"], params["conv"]["bias"])
    a, bx = _gates(params, x)
    h = rglru_scan(a, bx, h0=h0)
    y = h.to(u.dtype) * gate
    out = dense(params["out"], y)
    if return_state:
        return out, h[:, -1].float()
    return out


def rglru_init_state(cfg: RGLRUConfig, batch: int, dtype=torch.float32,
                     device: DeviceLike = None):
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, cfg.width), dtype=dtype, device=dev),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.width),
                            dtype=dtype, device=dev),
    }


def rglru_decode_step(params, cfg: RGLRUConfig, u, state):
    """One-token decode.  u: (B, 1, d_model).  Returns (out, new_state);
    ``state`` is not modified.  The conv buffer and the gates compute in
    the state's dtype against the weights, as the reference's type
    promotion does."""
    u0 = u[:, 0]
    gate = gelu(dense(params["in_gate"], u0))
    x = dense(params["in_x"], u0)
    dt = torch.promote_types(state["conv"].dtype, x.dtype)
    conv_buf = torch.cat([state["conv"].to(dt), x[:, None, :].to(dt)], 1)
    kernel, bias = params["conv"]["kernel"], params["conv"]["bias"]
    x = torch.einsum("bwc,wc->bc", conv_buf, kernel.to(dt)) + bias.to(dt)
    a, bx = _gates(params, x)
    h = a * state["h"] + bx
    y = h.to(u.dtype) * gate
    out = dense(params["out"], y)[:, None, :]
    return out, {"h": h.to(state["h"].dtype),
                 "conv": conv_buf[:, 1:].to(state["conv"].dtype)}


__all__ = ["RGLRUConfig", "rglru_decode_step", "rglru_forward",
           "rglru_init", "rglru_init_state", "rglru_scan"]
