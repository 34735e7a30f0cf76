"""Multi-head latent attention (MLA), DeepSeek-V3's attention, as
Moonlight-16B-A3B runs it: the full-sequence (prefill) path through K5 and
the one-token decode over a latent cache.

A layer (no query LoRA, as Moonlight and DeepSeek-V2-Lite have it):

* ``q_proj``: x -> H query heads of ``qk_nope_head_dim + qk_rope_head_dim``
  (128 + 64 = 192);
* ``kv_a_proj_with_mqa``: x -> a latent of ``kv_lora_rank`` (512) and one
  RoPE key of ``qk_rope_head_dim`` shared by every head; RMSNorm
  (``kv_a_layernorm``) on the latent; ``kv_b_proj``: latent -> H heads of
  ``qk_nope_head_dim`` key and ``v_head_dim`` value (128 + 128);
* RoPE on each head's query part ``q_pe`` and on the shared ``k_pe``, in
  the interleaved layout (transformers' ``rope_interleave``, its default:
  pairs of adjacent dims rotate together), the other dims of each head
  unrotated;
* the causal core over query and key heads of 192, scaled by 192 ** -0.5,
  and values of 128; ``o_proj`` back to ``d_model``.

The prefill core goes through K5 (``kernels.flash_attention``) with values
narrower than the queries and keys wherever autograd does not need q, k
and v (``nn.attention.needs_autograd``), as ``nn.attention.attention``
routes its cores: on the card K5 takes bf16 at these widths and refuses
anything else (a float32 model raises there; nothing falls back), and on
the CPU the wrapper computes its plain version.  The value heads are read
in place as a strided slice of ``kv_b_proj``'s output, the key heads
assembled once from their unrotated parts and the shared rotated
``k_pe``.  Under autograd (training) the core is K5's plain version
(``kernels.ref.attention_ref``) in float32, which is differentiable.

Decode keeps a **latent cache** a layer: ``c_kv`` (the normalised latent)
and ``k_pe`` (the rotated shared key), ``kv_lora_rank + qk_rope_head_dim``
values a token (576) where the decompressed heads would take ``H (192 +
128)`` (5,120).  A step uses the absorbed form: each head's unrotated
query is taken into the latent through ``kv_b_proj``'s key part, scored
against ``c_kv`` and, through its RoPE part, against ``k_pe``; the
weighted sum of latents is taken out through ``kv_b_proj``'s value part.
It is eager PyTorch, written in place into the cache as
``nn.attention.decode_attention`` writes its KV rows.

Spans (``repro_torch.tracing``), under the block's ``mla``: ``mla.q``,
``mla.kv`` (down-projection, norm, up-projection), ``mla.rope`` (RoPE and
the query and key assembly), ``mla.core`` (K5) and ``mla.out``.  Counter:
``cache_bytes`` (:func:`mla_counters`), the latent cache's bytes each
decode step reads, summed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tracing
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_ref
from repro_torch.nn.attention import flash_blocks, needs_autograd
from repro_torch.nn.layers import dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.nn.rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.qk_head_dim ** -0.5


def mla_init(gen: torch.Generator, cfg: MLAConfig, *, dtype=torch.float32,
             device: DeviceLike = None):
    """The four projections (no bias) and the latent's RMSNorm."""
    H, r = cfg.n_heads, cfg.kv_lora_rank

    def proj(i, o):
        return dense_init(gen, i, o, dtype=dtype, device=device)

    return {"q_proj": proj(cfg.d_model, H * cfg.qk_head_dim),
            "kv_a_proj_with_mqa": proj(cfg.d_model, r + cfg.qk_rope_head_dim),
            "kv_a_layernorm": rmsnorm_init(r, dtype, device),
            "kv_b_proj": proj(r, H * (cfg.qk_nope_head_dim
                                      + cfg.v_head_dim)),
            "o_proj": proj(H * cfg.v_head_dim, cfg.d_model)}


def _rope(cfg: MLAConfig, x, positions):
    """RoPE on x (B, S, H, d_rope) at ``positions`` (B, S).  Interleaved,
    as transformers computes it: the pairs (2i, 2i + 1) are gathered into
    halves ([0, 2, ...], [1, 3, ...]) and rotated in the rotate-half form,
    so the output holds each rotated pair split across the halves; queries
    and keys are laid out alike, so their dot products are the pairs'."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return apply_rope(x, positions, theta=cfg.rope_theta)


def _project(params, cfg: MLAConfig, x, positions):
    """q (B, S, H, 192) with its RoPE part rotated, the latent c (B, S, r)
    normalised and the rotated shared k_pe (B, S, 1, 64)."""
    B, S, _ = x.shape
    H, dn, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    with tracing.span("mla.q"):
        q = dense(params["q_proj"], x).view(B, S, H, cfg.qk_head_dim)
    with tracing.span("mla.kv"):
        ckv = dense(params["kv_a_proj_with_mqa"], x)
        c = rmsnorm(params["kv_a_layernorm"], ckv[..., :r], eps=cfg.norm_eps)
    with tracing.span("mla.rope"):
        # written into q's own storage: matmul saves no output for autograd
        q[..., dn:] = _rope(cfg, q[..., dn:], positions)
        k_pe = _rope(cfg, ckv[..., None, r:], positions)
    return q, c, k_pe


def mla_attention(params, cfg: MLAConfig, x):
    """Full-sequence causal MLA on x (B, S, d_model), positions 0 .. S - 1
    -> (B, S, d_model)."""
    B, S, _ = x.shape
    H, dn, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, c, k_pe = _project(params, cfg, x, positions)
    with tracing.span("mla.kv"):
        kv = dense(params["kv_b_proj"], c).view(B, S, H, dn + dv)
    with tracing.span("mla.rope"):
        k = q.new_empty((B, S, H, cfg.qk_head_dim))
        k[..., :dn] = kv[..., :dn]
        k[..., dn:] = k_pe
    v = kv[..., dn:]          # read in place: (B, S, H, dv), stride dn + dv
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    with tracing.span("mla.core"):
        if needs_autograd(params, x):
            o = attention_ref(q.float(), k.float(), v.float(), causal=True,
                              scale=cfg.softmax_scale).to(v.dtype)
        else:
            blk = flash_blocks(S)
            o = flash_attention(q, k, v, causal=True, block_q=blk,
                                block_k=blk, scale=cfg.softmax_scale)
    with tracing.span("mla.out"):
        return dense(params["o_proj"], o.transpose(1, 2).reshape(B, S,
                                                                 H * dv))


# ---------------------------------------------------------------------------
# Decode over the latent cache
# ---------------------------------------------------------------------------

class _Counts:
    cache_bytes = 0     # latent cache bytes the decode steps read


def mla_counters() -> dict:
    """What the MLA decode counted since :func:`reset_counters`:
    ``cache_bytes``, the latent cache's bytes each step read (the whole of
    its layer's ``c_kv`` and ``k_pe``), summed."""
    return {"cache_bytes": _Counts.cache_bytes}


def reset_counters() -> None:
    _Counts.cache_bytes = 0


def init_latent_cache(cfg: MLAConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = None):
    """{"c_kv" (batch, max_len, kv_lora_rank), "k_pe" (batch, max_len,
    qk_rope_head_dim)} zeros: 576 values a token at Moonlight's widths."""
    dev = resolve_device(device)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=dev),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                dtype=dtype, device=dev)}


@torch.no_grad()
def mla_decode(params, cfg: MLAConfig, x, cache, index):
    """One-token decode step in the absorbed form.

    x: (B, 1, d_model); cache: :func:`init_latent_cache`'s; index: the new
    token's position, a Python int or a 0-d integer tensor (kept on the
    device: nothing here reads it on the host).  Writes the token's latent
    and rotated k_pe into the cache at ``index`` (clamped to the cache's
    length, as ``nn.attention.decode_attention`` writes) and returns (out
    (B, 1, d_model), cache).  The scores, softmax and both sums run in
    float32 over every cached position up to ``index``."""
    B, S1, _ = x.shape
    assert S1 == 1, "mla_decode processes exactly one new token"
    H, dn, dv, r = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    index = torch.as_tensor(index, device=x.device)
    idx = index.to(torch.int64).reshape(())
    positions = idx.reshape(1, 1).expand(B, 1)
    q, c, k_pe = _project(params, cfg, x, positions)
    c_cache, pe_cache = cache["c_kv"], cache["k_pe"]
    S_max = c_cache.shape[1]
    row = idx.clamp(0, S_max - 1).reshape(1)
    c_cache.index_copy_(1, row, c.to(c_cache.dtype))
    pe_cache.index_copy_(1, row, k_pe[:, :, 0].to(pe_cache.dtype))
    _Counts.cache_bytes += (c_cache.numel() * c_cache.element_size()
                            + pe_cache.numel() * pe_cache.element_size())

    w = params["kv_b_proj"]["kernel"].float().view(r, H, dn + dv)
    q = q[:, 0].float()                                       # (B, H, 192)
    q_lat = torch.einsum("bhd,rhd->bhr", q[..., :dn], w[..., :dn])
    cf, pf = c_cache.float(), pe_cache.float()
    s = (torch.einsum("bhr,btr->bht", q_lat, cf)
         + torch.einsum("bhd,btd->bht", q[..., dn:], pf)) * cfg.softmax_scale
    valid = torch.arange(S_max, device=x.device) <= idx
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    o_lat = torch.einsum("bht,btr->bhr", p, cf)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w[..., dn:])     # (B, H, dv)
    out = dense(params["o_proj"], o.reshape(B, 1, H * dv).to(x.dtype))
    return out, cache


__all__ = ["MLAConfig", "init_latent_cache", "mla_attention", "mla_counters",
           "mla_decode", "mla_init", "reset_counters"]
