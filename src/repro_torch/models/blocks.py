"""Transformer blocks composed by ``repro_torch.models.transformer``
according to ``ArchConfig.pattern``, as in ``repro.models.blocks``: the
``attn`` and ``swa`` blocks (with every MLP kind or an MoE), the RG-LRU
``rec`` block, the Mamba-2 ``ssm`` block and, the port's own, the ``mla``
block (multi-head latent attention, ``nn.mla``, with the MoE, or with the
dense MLP of width ``cfg.d_ff_dense`` as a ``cfg.lead`` block), each with
its full-sequence forward, its cache and its one-token decode.

With ``cfg.ssm_ffn`` an ``ssm`` block carries the MLP (or MoE) after its
mixer, as granite-4.0-h's layers do, and every block scales each residual
branch by ``cfg.residual_multiplier``.  The mixers and the FFNs mark their
spans (``repro_torch.tracing``): ``attn``, ``ssm`` (with ``ssm.proj``,
``ssm.scan``, ``ssm.out``), ``mla`` (``nn.mla``'s inside it), ``moe``
(``nn.moe``) and ``mlp``.

Decode writes each cache in place, the KV row
(``nn.attention.decode_attention``), the latent row (``nn.mla``) and the
``rec``/``ssm`` states alike, where the reference returns new caches:
``DecoderModel.decode_step`` keeps the caches it was given.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.device import DeviceLike
from repro_torch.models.config import ArchConfig, MLAArch, SSMArch
from repro_torch.nn.attention import (AttentionConfig, attention,
                                     attention_init, decode_attention,
                                     init_kv_cache)
from repro_torch.nn.layers import (dense, gelu, gelu_mlp, gelu_mlp_init,
                                   layernorm, layernorm_init, rmsnorm,
                                   rmsnorm_init, swiglu, swiglu_init)
from repro_torch.nn.mla import (MLAConfig, init_latent_cache,
                                mla_attention, mla_decode, mla_init)
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_init
from repro_torch.nn.rglru import (RGLRUConfig, rglru_decode_step,
                                  rglru_forward, rglru_init,
                                  rglru_init_state)
from repro_torch.nn.ssm import (SSMConfig, ssm_decode_step, ssm_forward,
                                ssm_init, ssm_init_state)


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
        rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
        sliding_window=window, scale=cfg.attention_multiplier,
        attn_logit_softcap=cfg.logit_softcap,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        skip_masked_blocks=cfg.attn_skip_masked_blocks,
        windowed_decode_gather=cfg.windowed_decode_gather,
        masked_cache_update=cfg.masked_cache_update)


def moe_config(cfg: ArchConfig) -> MoEConfig:
    e = cfg.moe
    pad = 0
    if cfg.moe_pad_experts:
        pad = -(-e.n_experts // 16) * 16   # next multiple of the data axis
    return MoEConfig(d_model=cfg.d_model, d_ff_expert=cfg.d_ff,
                     n_experts=e.n_experts, top_k=e.top_k,
                     n_shared_experts=e.n_shared_experts,
                     shared_expert_gate=e.shared_expert_gate,
                     capacity_factor=e.capacity_factor,
                     group_size=cfg.moe_group_size,
                     pad_experts_to=pad,
                     expert_parallel=cfg.moe_expert_parallel,
                     dispatch_bf16=cfg.moe_dispatch_bf16,
                     d_ff_shared=e.d_ff_shared, dropless=e.dropless,
                     router=e.router, routed_scaling=e.routed_scaling)


def mla_config(cfg: ArchConfig) -> MLAConfig:
    m = cfg.mla or MLAArch()
    eps = {} if cfg.norm_eps is None else {"norm_eps": cfg.norm_eps}
    return MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                     kv_lora_rank=m.kv_lora_rank,
                     qk_nope_head_dim=m.qk_nope_head_dim,
                     qk_rope_head_dim=m.qk_rope_head_dim,
                     v_head_dim=m.v_head_dim, rope_theta=cfg.rope_theta,
                     **eps)


def ssm_config(cfg: ArchConfig) -> SSMConfig:
    s = cfg.ssm or SSMArch()
    eps = {} if cfg.norm_eps is None else {"norm_eps": cfg.norm_eps}
    return SSMConfig(d_model=cfg.d_model, d_state=s.d_state,
                     head_dim=s.head_dim, expand=s.expand,
                     n_groups=s.n_groups, conv_width=s.conv_width,
                     chunk=s.chunk, **eps)


def rglru_config(cfg: ArchConfig) -> RGLRUConfig:
    return RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.rnn_width)


# ---------------------------------------------------------------------------
# norms / mlps
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, dtype, device: DeviceLike = None):
    return (rmsnorm_init(cfg.d_model, dtype, device) if cfg.norm == "rmsnorm"
            else layernorm_init(cfg.d_model, dtype, device))


def norm_apply(cfg: ArchConfig, p, x):
    eps = {} if cfg.norm_eps is None else {"eps": cfg.norm_eps}
    return (rmsnorm(p, x, **eps) if cfg.norm == "rmsnorm"
            else layernorm(p, x, **eps))


def _branch(cfg: ArchConfig, h):
    """A residual branch's output, times ``cfg.residual_multiplier``."""
    r = cfg.residual_multiplier
    return h if r == 1.0 else h * r


def ffn_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device: DeviceLike = None, *, dense: bool = False):
    """The norm before a block's MLP (or MoE) and its weights; with
    ``dense`` (a ``cfg.lead`` block) the MLP of width ``cfg.d_ff_dense``."""
    p = {"norm2": norm_init(cfg, dtype, device)}
    if cfg.moe is not None and not dense:
        p["moe"] = moe_init(gen, moe_config(cfg), dtype=dtype, device=device)
    else:
        p["mlp"] = mlp_init(gen, cfg, dtype, device,
                            d_ff=cfg.d_ff_dense if dense else None)
    return p


def ffn_apply(params, cfg: ArchConfig, x):
    """x plus the block's MLP (or MoE, as its parameters hold) branch on
    ``norm2(x)``.  Returns (x, aux), aux the MoE's (empty for an MLP)."""
    h = norm_apply(cfg, params["norm2"], x)
    if "moe" in params:
        y, aux = moe_apply(params["moe"], moe_config(cfg), h)
    else:
        with tracing.span("mlp"):
            y, aux = mlp_apply(cfg, params["mlp"], h), {}
    return x + _branch(cfg, y), aux


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype,
             device: DeviceLike = None, d_ff=None):
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return swiglu_init(gen, cfg.d_model, d_ff, dtype=dtype,
                           device=device)
    return gelu_mlp_init(gen, cfg.d_model, d_ff,
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

def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               device: DeviceLike = None, *, dense: bool = False):
    """A block's parameters; ``dense``: a ``cfg.lead`` block, whose FFN is
    the dense MLP of width ``cfg.d_ff_dense``."""
    if kind == "mla":
        return {
            "norm1": norm_init(cfg, dtype, device),
            "mla": mla_init(gen, mla_config(cfg), dtype=dtype,
                            device=device),
            **ffn_init(gen, cfg, dtype, device, dense=dense),
        }
    if kind in ("attn", "swa"):
        return {
            "norm1": norm_init(cfg, dtype, device),
            "attn": attention_init(gen, attn_config(cfg, kind), dtype=dtype,
                                   device=device),
            **ffn_init(gen, cfg, dtype, device),
        }
    if kind == "rec":
        return {
            "norm1": norm_init(cfg, dtype, device),
            "rglru": rglru_init(gen, rglru_config(cfg), dtype=dtype,
                                device=device),
            "norm2": norm_init(cfg, dtype, device),
            "mlp": mlp_init(gen, cfg, dtype, device),
        }
    if kind == "ssm":
        p = {
            "norm": norm_init(cfg, dtype, device),
            "ssm": ssm_init(gen, ssm_config(cfg), dtype=dtype, device=device),
        }
        if cfg.ssm_ffn:
            p.update(ffn_init(gen, cfg, dtype, device))
        return p
    raise ValueError(kind)


def block_apply(params, cfg: ArchConfig, kind: str, x, *,
                long_ctx: bool = False):
    """Full-sequence forward.  Returns (x, aux); aux holds the MoE's
    ``moe_aux_loss``, ``router_entropy`` and routing, else nothing."""
    aux = {}
    if kind == "mla":
        with tracing.span("mla"):
            h = mla_attention(params["mla"], mla_config(cfg),
                              norm_apply(cfg, params["norm1"], x))
        return ffn_apply(params, cfg, x + _branch(cfg, h))
    if kind in ("attn", "swa"):
        acfg = attn_config(cfg, kind, long_ctx=long_ctx)
        with tracing.span("attn"):
            h = attention(params["attn"], acfg,
                          norm_apply(cfg, params["norm1"], x))
        return ffn_apply(params, cfg, x + _branch(cfg, h))
    if kind == "rec":
        x = x + rglru_forward(params["rglru"], rglru_config(cfg),
                              norm_apply(cfg, params["norm1"], x))
        y = mlp_apply(cfg, params["mlp"], norm_apply(cfg, params["norm2"], x))
        return x + y, aux
    if kind == "ssm":
        with tracing.span("ssm"):
            h = ssm_forward(params["ssm"], ssm_config(cfg),
                            norm_apply(cfg, params["norm"], x))
        x = x + _branch(cfg, h)
        return ffn_apply(params, cfg, x) if cfg.ssm_ffn else (x, aux)
    raise ValueError(kind)


def block_init_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype, device: DeviceLike = None):
    """A zero cache: the KV cache in ``dtype`` for attention, the latent
    cache in ``dtype`` for ``mla``, the f32 recurrent state and conv buffer
    for ``rec`` and ``ssm``."""
    if kind == "mla":
        return init_latent_cache(mla_config(cfg), batch, max_len, dtype,
                                 device)
    if kind in ("attn", "swa"):
        return init_kv_cache(attn_config(cfg, kind), batch, max_len, dtype,
                             device)
    if kind == "rec":
        return rglru_init_state(rglru_config(cfg), batch, torch.float32,
                                device)
    if kind == "ssm":
        return ssm_init_state(ssm_config(cfg), batch, torch.float32, device)
    raise ValueError(kind)


def _write_state(cache, new):
    """Copy a recurrent block's new state into its cache's own tensors."""
    for k, t in new.items():
        cache[k].copy_(t)
    return cache


def block_decode(params, cfg: ArchConfig, kind: str, x, cache, index, *,
                 long_ctx: bool = False):
    """One-token decode.  Returns (x, cache), the cache written in place:
    the KV row (``nn.attention.decode_attention``), the latent row
    (``nn.mla.mla_decode``), or the ``rec``/``ssm`` state and its shifted
    conv buffer."""
    if kind == "mla":
        h, cache = mla_decode(params["mla"], mla_config(cfg),
                              norm_apply(cfg, params["norm1"], x), cache,
                              index)
        return ffn_apply(params, cfg, x + _branch(cfg, h))[0], cache
    if kind in ("attn", "swa"):
        acfg = attn_config(cfg, kind, long_ctx=long_ctx)
        h, cache = decode_attention(params["attn"], acfg,
                                    norm_apply(cfg, params["norm1"], x),
                                    cache, index)
        return ffn_apply(params, cfg, x + _branch(cfg, h))[0], cache
    if kind == "rec":
        h, new = rglru_decode_step(params["rglru"], rglru_config(cfg),
                                   norm_apply(cfg, params["norm1"], x), cache)
        x = x + h
        y = mlp_apply(cfg, params["mlp"], norm_apply(cfg, params["norm2"], x))
        return x + y, _write_state(cache, new)
    if kind == "ssm":
        h, new = ssm_decode_step(params["ssm"], ssm_config(cfg),
                                 norm_apply(cfg, params["norm"], x), cache)
        x = x + _branch(cfg, h)
        if cfg.ssm_ffn:
            x = ffn_apply(params, cfg, x)[0]
        return x, _write_state(cache, new)
    raise ValueError(kind)


__all__ = ["attn_config", "block_apply", "block_decode", "block_init",
           "block_init_cache", "ffn_apply", "ffn_init", "mlp_apply",
           "mla_config", "mlp_init", "moe_config",
           "norm_apply", "norm_init", "rglru_config", "ssm_config"]
