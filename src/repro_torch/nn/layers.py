"""Dense and conv2d layers (NHWC activations, HWIO kernels), as in
``repro.nn.layers``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.module import fan_in_init


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
    y = x @ params["kernel"]
    if "bias" in params:
        y = y + params["bias"]
    return y


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


__all__ = ["conv2d", "conv2d_init", "dense", "dense_init"]
