"""Plain PyTorch versions of the port's CUDA kernels.

Each computes what its kernel computes, the MiniConv ones with ``F.pad`` +
``F.conv2d`` and attention with two einsums and a softmax: the wrappers in
``kernels/miniconv_pass.py`` and ``kernels/flash_attention.py`` use them
for CPU tensors (the tests), and ``chip_smoke.py`` holds each kernel
against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.miniconv import _ACTS


def miniconv_pass_ref(x, w, b, *, stride: int = 1):
    """VALID conv matching ``miniconv_pass``: x (B, H_in, W_in, C_in)
    pre-padded, w (kh, kw, C_in, 4), b (4,) -> (B, H_out, W_out, 4)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), b.float(), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def miniconv_layer_grouped_ref(x, w, b, *, stride: int = 1):
    """VALID conv matching ``miniconv_layer_grouped``: every output group
    of the layer in one ``F.conv2d``; w (kh, kw, C_in, C_out), b (C_out,)
    -> (B, H_out, W_out, C_out)."""
    return miniconv_pass_ref(x, w, b, stride=stride)


def miniconv_encoder_ref(x, weights, biases, plan, *, head_w=None,
                         head_b=None, head_act: str = "relu"):
    """Every layer of ``plan`` with explicit SAME padding (``same_pads``
    is asymmetric when odd), then the optional projection on the NHWC
    flattened features.  Matches ``miniconv_encoder``."""
    y = x.permute(0, 3, 1, 2).float()
    for l, w, b in zip(plan.layers, weights, biases):
        y = F.pad(y, (l.pad_left, l.pad_right, l.pad_top, l.pad_bottom))
        y = F.conv2d(y, w.permute(3, 2, 0, 1).float(), b.float(),
                     stride=l.stride)
        y = _ACTS[l.activation](y)
    feats = y.permute(0, 2, 3, 1).contiguous()
    if head_w is None:
        return feats
    z = feats.reshape(feats.shape[0], -1) @ head_w
    if head_b is not None:
        z = z + head_b
    return feats, _ACTS[head_act](z)


def miniconv_encoder_stream_ref(x, weights, biases, plan, *, head_w=None,
                                head_b=None, head_act: str = "relu"):
    """Matches ``miniconv_encoder_stream``.  Streaming the batch in chunks
    changes no arithmetic, so this is the encoder's plain version."""
    return miniconv_encoder_ref(x, weights, biases, plan, head_w=head_w,
                                head_b=head_b, head_act=head_act)


def attention_ref(q, k, v, *, causal: bool = True,
                  sliding_window: Optional[int] = None, scale=None):
    """Matches ``flash_attention`` (a copy of the reference's oracle).
    q, k, v: (B, H, S, D) -> (B, H, S, D) in v's dtype."""
    B, H, S, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window is not None:
        mask &= k_pos > q_pos - sliding_window
    logits = torch.where(mask[None, None], logits,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def moe_grouped_ref(x, offsets, w_gate, w_up, w_down, row_scale=None):
    """K7's plain version: expert e's rows ``x[offsets[e]:offsets[e+1]]``
    through its SwiGLU by per-expert ``torch.matmul``, in float32, the
    hidden ``silu(x Wg) * (x Wu)`` rounded once to x's dtype as the kernel
    stores it; row r's output times ``row_scale[r]``.  Returns (M, D)
    float32."""
    out = torch.zeros((x.shape[0], w_down.shape[2]), dtype=torch.float32,
                      device=x.device)
    bounds = offsets.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi <= lo:
            continue
        xe = x[lo:hi].float()
        g = torch.matmul(xe, w_gate[e].float())
        u = torch.matmul(xe, w_up[e].float())
        h = (torch.nn.functional.silu(g) * u).to(x.dtype).float()
        out[lo:hi] = torch.matmul(h, w_down[e].float())
    if row_scale is not None:
        out *= row_scale.float()[:, None]
    return out


__all__ = ["attention_ref", "moe_grouped_ref", "miniconv_encoder_ref",
           "miniconv_encoder_stream_ref", "miniconv_layer_grouped_ref",
           "miniconv_pass_ref"]
