"""Mamba-2 (SSD — state-space duality) layer, as in ``repro.nn.ssm``.
[arXiv:2405.21060]

The full sequence runs the chunked SSD algorithm: a quadratic term
within each chunk, then a linear recurrence over the chunk states (a
loop over chunks: one chunk at S <= 256).  Decode is the O(1) recurrent
update.  The scan computes in f32 whatever the model's dtype; ``A_log``,
``D`` and ``dt_bias`` stay f32, as in the reference.  Where autograd does
not need the scan's inputs (every prefill and decision) the scan is K8
(``kernels.ssd_scan``), which reads x, B and C where the conv left them;
where it does (training), or on DTensors, it is the plain
``ssd_chunked`` (``kernels.ref``), which has a backward.

The full-sequence forward marks three spans (``repro_torch.tracing``):
``ssm.proj`` (the input projection and the causal conv), ``ssm.scan``
(the chunked SSD) and ``ssm.out`` (the gated RMSNorm and the output
projection).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ref import ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.nn.constrain import is_dtensor
from repro_torch.nn.layers import dense, dense_init, rmsnorm, rmsnorm_init


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256
    norm_eps: float = 1e-6      # the gated RMSNorm's (granite-4.0-h: 1e-5)

    # fields the JAX package's dataclass lacks
    # (``models.config.port_only_dict``)
    PORT_ONLY: ClassVar[tuple] = ("norm_eps",)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen: torch.Generator, cfg: SSMConfig, *, dtype=torch.float32,
             device: DeviceLike = None):
    dev = resolve_device(device)
    d_in = cfg.d_inner
    G, N, H = cfg.n_groups, cfg.d_state, cfg.n_heads
    proj_out = 2 * d_in + 2 * G * N + H  # [z, x, B, C, dt]
    conv_dim = d_in + 2 * G * N
    in_proj = dense_init(gen, cfg.d_model, proj_out, dtype=dtype, device=dev)
    conv = torch.randn((cfg.conv_width, conv_dim), generator=gen,
                       device=gen.device) * 0.1
    return {
        "in_proj": in_proj,
        "conv": {"kernel": conv.to(dev, dtype),
                 "bias": torch.zeros((conv_dim,), dtype=dtype, device=dev)},
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_in, dtype, dev),
        "out_proj": dense_init(gen, d_in, cfg.d_model, dtype=dtype,
                               device=dev),
    }


def _split_proj(cfg: SSMConfig, zxbcdt):
    d_in, G, N, H = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * G * N]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _causal_conv(xBC, kernel, bias):
    """Depthwise causal conv along sequence.  xBC: (B,S,Cc); kernel: (W,Cc)."""
    W = kernel.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1], :] * kernel[i] for i in range(W))
    return F.silu(out + bias)


def ssm_forward(params, cfg: SSMConfig, u, *, h0=None,
                return_state: bool = False):
    """Full-sequence forward.  u: (B, S, d_model)."""
    B_, S, _ = u.shape
    G, N, H, P = cfg.n_groups, cfg.d_state, cfg.n_heads, cfg.head_dim
    with tracing.span("ssm.proj"):
        zxbcdt = dense(params["in_proj"], u)
        z, xBC, dt = _split_proj(cfg, zxbcdt)
        xBC = _causal_conv(xBC, params["conv"]["kernel"],
                           params["conv"]["bias"])
    with tracing.span("ssm.scan"):
        x = xBC[..., :cfg.d_inner].reshape(B_, S, H, P)
        Bm = xBC[..., cfg.d_inner:cfg.d_inner + G * N].reshape(B_, S, G, N)
        Cm = xBC[..., cfg.d_inner + G * N:].reshape(B_, S, G, N)
        dt = F.softplus(dt.float() + params["dt_bias"])
        A = -torch.exp(params["A_log"])
        args = (x, dt, A, Bm, Cm, params["D"], h0)
        if is_dtensor(x) or (torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in args)):
            y, h = ssd_chunked(cfg, x.float(), dt, A, Bm.float(), Cm.float(),
                               params["D"], h0=h0)
        else:
            y, h = ssd_scan(cfg, x, dt, A, Bm, Cm, params["D"], h0=h0)
    with tracing.span("ssm.out"):
        y = y.reshape(B_, S, cfg.d_inner).to(u.dtype)
        y = rmsnorm(params["norm"], y * F.silu(z), eps=cfg.norm_eps)
        out = dense(params["out_proj"], y)
    if return_state:
        return out, h
    return out


def ssm_init_state(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device: DeviceLike = None):
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                         dtype=dtype, device=dev),
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.n_groups * cfg.d_state),
                            dtype=dtype, device=dev),
    }


def ssm_decode_step(params, cfg: SSMConfig, u, state):
    """One-token decode.  u: (B, 1, d_model).  Returns (out, new_state);
    ``state`` is not modified.  The conv buffer computes in the state's
    dtype against the weights, as the reference's type promotion does."""
    B_ = u.shape[0]
    G, N, H, P = cfg.n_groups, cfg.d_state, cfg.n_heads, cfg.head_dim
    zxbcdt = dense(params["in_proj"], u[:, 0])
    z, xBC, dt = _split_proj(cfg, zxbcdt)

    # rolling conv state
    cdt = torch.promote_types(state["conv"].dtype, xBC.dtype)
    conv_buf = torch.cat([state["conv"].to(cdt), xBC[:, None, :].to(cdt)], 1)
    kernel, bias = params["conv"]["kernel"], params["conv"]["bias"]
    xBC = F.silu(torch.einsum("bwc,wc->bc", conv_buf, kernel.to(cdt))
                 + bias.to(cdt))

    x = xBC[..., :cfg.d_inner].reshape(B_, H, P)
    Bm = xBC[..., cfg.d_inner:cfg.d_inner + G * N].reshape(B_, G, N)
    Cm = xBC[..., cfg.d_inner + G * N:].reshape(B_, G, N)
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1).float()   # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()

    dt = F.softplus(dt.float() + params["dt_bias"])                  # (B,H)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                                   # (B,H)

    xf = x.float()
    h = state["h"] * dA[:, :, None, None] \
        + (dt[:, :, None] * xf)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    y = y + xf * params["D"][None, :, None]
    y = y.reshape(B_, cfg.d_inner).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z), eps=cfg.norm_eps)
    out = dense(params["out_proj"], y)[:, None, :]
    return out, {"h": h.to(state["h"].dtype),
                 "conv": conv_buf[:, 1:].to(state["conv"].dtype)}


__all__ = ["SSMConfig", "ssd_chunked", "ssm_decode_step", "ssm_forward",
           "ssm_init", "ssm_init_state"]
