"""Rotary position embeddings (RoPE), as in ``repro.nn.rotary``: the
rotate-half form, computed in float32 and cast back; and the sinusoidal
table of the Whisper encoder."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)          # (D/2,)
    angles = positions[..., :, None, None].float() * freqs       # (...,S,1,D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int,
                         device=None) -> torch.Tensor:
    """Classic transformer sinusoidal table (used by the Whisper encoder):
    (seq_len, dim) float32, sines then cosines, with the reference's
    ``max(half - 1, 1)`` denominator."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / max(
        half - 1, 1)
    # the power rounded once from float64: XLA's float32 power is
    # correctly rounded where torch's may be an ulp off, and at 1,500
    # frames an ulp of the frequency moves an angle by 1e-4
    inv = 1.0 / (10000.0 ** exps.double()).float()
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


__all__ = ["apply_rope", "rope_frequencies", "sinusoidal_positions"]
