"""Plain PyTorch versions of the port's CUDA kernels.

Each computes what its kernel computes, the MiniConv ones with ``F.pad`` +
``F.conv2d``, attention with two einsums and a softmax and the chunked SSD
scan with einsums and a loop over chunks: the wrappers in ``kernels/`` use
them for CPU tensors (the tests), ``nn.ssm`` takes ``ssd_chunked`` where
autograd needs the scan's inputs, and ``chip_smoke.py`` holds each kernel
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


def moe_combine_ref(out, pos, shared=None, *, dtype):
    """K9's plain version: row t is ``sum_k out[pos[t, k]]`` in float32,
    plus ``shared[t]`` as float32 where given, rounded once to ``dtype``.
    out (M, D) float32, pos (T, K) of row numbers, shared (T, D) or None.
    Differentiable in ``out`` and ``shared``."""
    y = out[pos.long()].sum(1)
    if shared is not None:
        y = y + shared.float()
    return y.to(dtype)


def _segsum(x):
    """x: (..., L).  Returns seg[..., i, j] = sum_{k=j+1..i} x_k (lower-tri,
    -inf above the diagonal).

    Each entry is its own sum, a cumulative sum down the columns of x
    masked to the strict lower triangle.  The reference takes differences
    of one cumulative sum, cs_i - cs_j, which cancel: over a 256-step
    chunk |cs| reaches 10^3, so the short sums near the diagonal, whose
    exp matters most, carry absolute errors near 1e-4, and their exp as
    much relative error.
    """
    L = x.shape[-1]
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril
    terms = x[..., :, None].expand(*x.shape, L).masked_fill(~tril(-1), 0.0)
    return torch.cumsum(terms, dim=-2).masked_fill(~tril(0), float("-inf"))


def ssd_chunked(cfg, x, dt, A, B, C, D, *, h0=None):
    """Chunked SSD scan (``nn.ssm``'s, and K8's plain version); ``cfg`` is
    an ``nn.ssm.SSMConfig``, of which it reads ``chunk``.

    x: (b, S, H, P); dt: (b, S, H) (post softplus); A: (H,) negative;
    B, C: (b, S, G, N); D: (H,).  Returns (y, h_final) with
    h_final: (b, H, P, N).
    """
    b, S, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    Q = min(cfg.chunk, S)
    assert S % Q == 0, f"seq {S} not divisible by chunk {Q}"
    c = S // Q
    rep = H // G

    xc = x.reshape(b, c, Q, H, P)
    dtc = dt.reshape(b, c, Q, H)
    Bh = B.reshape(b, c, Q, G, N).repeat_interleave(rep, dim=3)  # (b,c,Q,H,N)
    Ch = C.reshape(b, c, Q, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A                                         # (b,c,Q,H)
    dA_cs = torch.cumsum(dA, dim=2)                      # within-chunk cumsum

    # 1. within-chunk (quadratic) term
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))    # (b,c,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    M = scores * Lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M, xc)

    # 2. per-chunk input states; the decay from each step to the chunk's
    # end, exp(sum_{k>q} dA_k), is Lmat's last row
    decay_states = Lmat[:, :, :, -1, :].permute(0, 1, 3, 2)  # (b,c,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bh * (decay_states * dtc)[..., None], xc)

    # 3. inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])          # (b,c,H)
    h = (torch.zeros((b, H, P, N), dtype=states.dtype, device=x.device)
         if h0 is None else h0)
    h_in = []                                            # entering each chunk
    for i in range(c):
        h_in.append(h)
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_in = torch.stack(h_in, 1)                          # (b,c,H,P,N)

    # 4. chunk-output from incoming states
    out_decay = torch.exp(dA_cs)                         # (b,c,Q,H)
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch * out_decay[..., None],
                         h_in)

    y = (y_diag + y_off).reshape(b, S, H, P)
    y = y + x * D[None, None, :, None]
    return y, h


__all__ = ["attention_ref", "moe_combine_ref", "moe_grouped_ref",
           "miniconv_encoder_ref", "miniconv_encoder_stream_ref",
           "miniconv_layer_grouped_ref", "miniconv_pass_ref", "ssd_chunked"]
