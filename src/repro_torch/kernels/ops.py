"""One MiniConv layer as per-pass kernel launches (the ``reference``
tier) or one grouped launch (the ``grouped`` tier), and causal attention
through K5, as in ``repro.kernels.ops``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.passplan import same_pads
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.miniconv_pass import (miniconv_encoder,
                                               miniconv_layer_grouped,
                                               miniconv_pass)


def same_pad(x, kernel: int, stride: int):
    """SAME padding of an NHWC tensor for a square kernel, so the VALID
    pass reproduces a SAME conv."""
    pt, pb = same_pads(x.shape[1], kernel, stride)
    pl, pr = same_pads(x.shape[2], kernel, stride)
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def _pad_groups(kernel, bias):
    """Zero-pad the output channels to a multiple of 4 (RGBA packing).

    ``LayerSpec.n_passes = ceil(c_out/4)`` admits c_out % 4 != 0; the final
    output group then renders a partially-used RGBA target.  The pass
    kernel always writes 4 channels, so the weights/bias gain zero
    channels and the caller slices the result back.
    """
    c_out = kernel.shape[-1]
    pad = (-c_out) % 4
    if pad:
        kernel = F.pad(kernel, (0, pad))
        bias = F.pad(bias, (0, pad))
    return kernel, bias, c_out


def miniconv_layer(x, kernel, bias, *, stride: int = 1,
                   fused_groups: bool = False):
    """One MiniConv layer = ceil(c_out/4) shader passes (SAME padding).

    x: (B,H,W,C_in); kernel: (kh,kw,C_in,C_out); bias: (C_out,).
    ``fused_groups=True`` runs every output group in ONE
    ``miniconv_layer_grouped`` launch; the default launches
    ``miniconv_pass`` once per 4-channel output group (the reference path).
    Both sum in the same order, so they agree bit for bit.
    """
    kh = kernel.shape[0]
    kernel, bias, c_out = _pad_groups(kernel, bias)
    xp = same_pad(x, kh, stride)
    if fused_groups:
        out = miniconv_layer_grouped(xp, kernel, bias, stride=stride)
    else:
        outs = [miniconv_pass(xp, kernel[..., g:g + 4], bias[g:g + 4],
                              stride=stride)
                for g in range(0, kernel.shape[-1], 4)]
        out = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
    return out[..., :c_out]


def causal_attention(q, k, v, *, sliding_window: Optional[int] = None,
                     block_q: int = 128, block_k: int = 128):
    """(B, H, S, D) causal flash attention: K5 on CUDA tensors, its plain
    version on CPU tensors.  k and v may carry fewer heads (GQA) and any
    of the three may be a strided view, such as a transposed (B, S, H, D)
    projection; K5 reads both in place."""
    return flash_attention(q, k, v, causal=True,
                           sliding_window=sliding_window,
                           block_q=block_q, block_k=block_k)


__all__ = ["miniconv_layer", "causal_attention", "miniconv_pass",
           "miniconv_layer_grouped", "miniconv_encoder", "flash_attention",
           "same_pad"]
