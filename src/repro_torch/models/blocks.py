"""Transformer blocks composed by ``repro_torch.models.transformer``
according to ``ArchConfig.pattern``, as in ``repro.models.blocks``: the
``attn`` and ``swa`` blocks with every MLP kind, their full-sequence
forward, their KV cache and their one-token decode.

The RG-LRU (``rec``) and Mamba-2 (``ssm``) blocks and MoE MLPs raise
``NotImplementedError``: they come with ROADMAP queue 1, item 2.3.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ArchConfig
from repro_torch.nn.attention import (AttentionConfig, attention,
                                     attention_init, decode_attention,
                                     init_kv_cache)
from repro_torch.nn.layers import (dense, gelu, gelu_mlp, gelu_mlp_init,
                                   layernorm, layernorm_init, rmsnorm,
                                   rmsnorm_init, swiglu, swiglu_init)

_LATER = ("is not ported yet (ROADMAP queue 1, item 10: MoE, SSM and "
          "RG-LRU come after the decode path and training)")


def attn_config(cfg: ArchConfig, kind: str, *,
                long_ctx: bool = False) -> AttentionConfig:
    window = None
    if kind == "swa":
        window = cfg.sliding_window
    elif long_ctx:
        # dense archs run long_500k with a sliding-window variant
        window = cfg.long_context_window
    return AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, sliding_window=window,
        attn_logit_softcap=cfg.logit_softcap,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        skip_masked_blocks=cfg.attn_skip_masked_blocks,
        windowed_decode_gather=cfg.windowed_decode_gather,
        masked_cache_update=cfg.masked_cache_update)


# ---------------------------------------------------------------------------
# norms / mlps
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, dtype, device: DeviceLike = None):
    return (rmsnorm_init(cfg.d_model, dtype, device) if cfg.norm == "rmsnorm"
            else layernorm_init(cfg.d_model, dtype, device))


def norm_apply(cfg: ArchConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device: DeviceLike = None):
    if cfg.mlp in ("swiglu", "geglu"):
        return swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                           device=device)
    return gelu_mlp_init(gen, cfg.d_model, cfg.d_ff,
                         use_bias=cfg.mlp == "gelu", dtype=dtype,
                         device=device)


def mlp_apply(cfg: ArchConfig, p, x):
    if cfg.mlp == "swiglu":
        return swiglu(p, x)
    if cfg.mlp == "geglu":
        g = gelu(dense(p["gate"], x))
        return dense(p["down"], g * dense(p["up"], x))
    if cfg.mlp == "relu2":  # minitron/nemotron: squared ReLU, no gate
        h = torch.relu(dense(p["up"], x))
        return dense(p["down"], h * h)
    return gelu_mlp(p, x)


# ---------------------------------------------------------------------------
# block init / apply / decode / cache
# ---------------------------------------------------------------------------

def _check_kind(cfg: ArchConfig, kind: str) -> None:
    if kind in ("rec", "ssm"):
        raise NotImplementedError(f"block kind {kind!r} {_LATER}")
    if kind not in ("attn", "swa"):
        raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE MLP of {cfg.arch_id} {_LATER}")


def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               device: DeviceLike = None):
    _check_kind(cfg, kind)
    return {
        "norm1": norm_init(cfg, dtype, device),
        "attn": attention_init(gen, attn_config(cfg, kind), dtype=dtype,
                               device=device),
        "norm2": norm_init(cfg, dtype, device),
        "mlp": mlp_init(gen, cfg, dtype, device),
    }


def block_apply(params, cfg: ArchConfig, kind: str, x, *,
                long_ctx: bool = False):
    """Full-sequence forward.  Returns (x, aux)."""
    _check_kind(cfg, kind)
    acfg = attn_config(cfg, kind, long_ctx=long_ctx)
    x = x + attention(params["attn"], acfg,
                      norm_apply(cfg, params["norm1"], x))
    y = mlp_apply(cfg, params["mlp"], norm_apply(cfg, params["norm2"], x))
    return x + y, {}


def block_init_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype, device: DeviceLike = None):
    _check_kind(cfg, kind)
    return init_kv_cache(attn_config(cfg, kind), batch, max_len, dtype,
                         device)


def block_decode(params, cfg: ArchConfig, kind: str, x, cache, index, *,
                 long_ctx: bool = False):
    """One-token decode.  Returns (x, cache), the cache written in place
    (``nn.attention.decode_attention``)."""
    _check_kind(cfg, kind)
    acfg = attn_config(cfg, kind, long_ctx=long_ctx)
    h, cache = decode_attention(params["attn"], acfg,
                                norm_apply(cfg, params["norm1"], x),
                                cache, index)
    x = x + h
    y = mlp_apply(cfg, params["mlp"], norm_apply(cfg, params["norm2"], x))
    return x + y, cache


__all__ = ["attn_config", "block_apply", "block_decode", "block_init",
           "block_init_cache", "mlp_apply", "mlp_init", "norm_apply",
           "norm_init"]
