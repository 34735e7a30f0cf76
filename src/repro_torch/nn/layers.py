"""Dense, embedding, norms, conv2d (NHWC activations, HWIO kernels) and
MLP blocks, as in ``repro.nn.layers``.

Every initialiser draws each tensor from the given generator and moves it
to ``device`` at once, so a full-width model never sits whole on the host.
Norms compute in float32 and cast back to the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.constrain import constrain, gathered, reduced
from repro_torch.nn.module import fan_in_init, normal_init


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = False, dtype=torch.float32, init=None,
               device: DeviceLike = None):
    dev = resolve_device(device)
    init = init or fan_in_init()
    p = {"kernel": init(gen, (in_dim, out_dim), dtype).to(dev)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=dev)
    return p


def dense(params, x):
    w = gathered(params["kernel"])
    # one 2-D product over the flattened rows, as ``@`` computes a
    # contiguous plain x (DTensor's ``@`` can take its batched form)
    y = reduced(x.reshape(-1, x.shape[-1]) @ w).reshape(
        *x.shape[:-1], w.shape[-1])
    if "bias" in params:
        y = y + params["bias"]
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, dim: int, *,
                   dtype=torch.float32, stddev: float = 0.02,
                   device: DeviceLike = None):
    dev = resolve_device(device)
    return {"embedding": normal_init(stddev)(gen, (vocab, dim), dtype)
            .to(dev)}


def embed(params, ids):
    return F.embedding(ids, gathered(params["embedding"]))


def unembed(params, x):
    """Tied logits projection."""
    w = gathered(params["embedding"]).T
    # one 2-D product, as in ``dense``
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(
        *x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype=torch.float32, device: DeviceLike = None):
    return {"scale": torch.ones((dim,), dtype=dtype,
                                device=resolve_device(device))}


def rmsnorm(params, x, *, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def layernorm_init(dim: int, dtype=torch.float32, device: DeviceLike = None):
    dev = resolve_device(device)
    return {"scale": torch.ones((dim,), dtype=dtype, device=dev),
            "bias": torch.zeros((dim,), dtype=dtype, device=dev)}


def layernorm(params, x, *, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Conv2D (NHWC, HWIO kernel) — used by the MiniConv / Full-CNN encoders
# ---------------------------------------------------------------------------

def conv2d_init(gen: torch.Generator, kh: int, kw: int, c_in: int,
                c_out: int, *, use_bias: bool = True, dtype=torch.float32,
                init=None, device: DeviceLike = None):
    dev = resolve_device(device)
    init = init or fan_in_init()
    kernel = init(gen, (kh, kw, c_in, c_out), dtype)
    # fan-in for conv counts the receptive field
    kernel = kernel / torch.sqrt(torch.tensor(kh * kw, dtype=dtype))
    p = {"kernel": kernel.to(dev)}
    if use_bias:
        p["bias"] = torch.zeros((c_out,), dtype=dtype, device=dev)
    return p


def conv2d(params, x, *, stride: int = 1, padding: str = "SAME"):
    """x: (B, H, W, C_in) -> (B, H', W', C_out).

    SAME padding is applied explicitly from ``same_pads``: it is
    asymmetric when the total is odd, which ``F.conv2d(padding=...)``
    cannot express (and it rejects ``"same"`` with a stride).
    """
    kh, kw = params["kernel"].shape[:2]
    xt = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        from repro_torch.core.passplan import same_pads  # lazy: avoids cycle
        pt, pb = same_pads(x.shape[1], kh, stride)
        pl, pr = same_pads(x.shape[2], kw, stride)
        xt = F.pad(xt, (pl, pr, pt, pb))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = F.conv2d(xt, params["kernel"].permute(3, 2, 0, 1),
                 params.get("bias"), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU) and classic MLP
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                dtype=torch.float32, device: DeviceLike = None):
    return {
        "gate": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "up": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "down": dense_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def _hidden_dims(x):
    return ("batch",) + (None,) * (x.ndim - 2) + ("model",)


def swiglu(params, x):
    g = F.silu(dense(params["gate"], x))
    h = constrain(g * dense(params["up"], x), _hidden_dims(x))
    return dense(params["down"], h)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
                  use_bias: bool = True, dtype=torch.float32,
                  device: DeviceLike = None):
    return {
        "up": dense_init(gen, d_model, d_ff, use_bias=use_bias, dtype=dtype,
                         device=device),
        "down": dense_init(gen, d_ff, d_model, use_bias=use_bias,
                           dtype=dtype, device=device),
    }


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(params, x):
    h = constrain(gelu(dense(params["up"], x)), _hidden_dims(x))
    return dense(params["down"], h)


__all__ = ["conv2d", "conv2d_init", "dense", "dense_init", "embed",
           "embedding_init", "gelu", "gelu_mlp", "gelu_mlp_init",
           "layernorm", "layernorm_init", "rmsnorm", "rmsnorm_init",
           "swiglu", "swiglu_init", "unembed"]
