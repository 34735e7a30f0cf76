"""Whisper-style encoder–decoder backbone (audio), as in
``repro.models.whisper``.  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor frontend is a stub: the
caller passes precomputed frame embeddings of shape (B, n_frames,
d_model) (``data.frontend_batches``); this module is the transformer
backbone that consumes them — a bidirectional encoder (sinusoidal
positions) and a causal decoder with cross-attention (learned positions).

The encoder's self-attention is non-causal and the decoder's causal; both
go through K5 where ``nn.attention.flash_eligible`` admits them and
autograd does not need q, k and v, at any length (1,500 frames, up to 448
decoder positions).  Cross-attention and the one-token decode step are
eager, as in the reference.

Layer weights are stacked under ``"enc_scan"`` and ``"dec_scan"``, each
leaf with a leading layer axis, exactly as the reference stacks them; a
Python loop over that axis takes the place of ``lax.scan``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import _draw_stacked, _unstack
from repro_torch.nn.constrain import checkpoint_context_fn, constrain_act
from repro_torch.nn.attention import (AttentionConfig, attention,
                                      attention_init, cross_attention,
                                      cross_kv, decode_attention,
                                      init_kv_cache)
from repro_torch.nn.layers import (embed, embedding_init, gelu_mlp,
                                   gelu_mlp_init, layernorm, layernorm_init,
                                   unembed)
from repro_torch.nn.losses import softmax_cross_entropy
from repro_torch.nn.module import no_draw, tree_map
from repro_torch.nn.rotary import sinusoidal_positions


def _attn_cfg(cfg: ArchConfig, *, causal: bool, long_ctx: bool = False):
    window = cfg.long_context_window if (causal and long_ctx) else None
    return AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        qkv_bias=True, use_rope=False, causal=causal,
        sliding_window=window,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
        skip_masked_blocks=cfg.attn_skip_masked_blocks,
        windowed_decode_gather=cfg.windowed_decode_gather)


class WhisperModel:
    """cfg.n_layers = decoder depth; cfg.n_encoder_layers = encoder depth;
    cfg.n_frontend_tokens = encoder frames (1500 for 30 s audio)."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.max_target_positions = 448  # whisper's decoder position table

    # ------------------------------------------------------------------ init
    def _enc_block_init(self, gen, dtype, dev):
        cfg = self.cfg
        return {
            "norm1": layernorm_init(cfg.d_model, dtype, dev),
            "attn": attention_init(gen, _attn_cfg(cfg, causal=False),
                                   dtype=dtype, device=dev),
            "norm2": layernorm_init(cfg.d_model, dtype, dev),
            "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                 device=dev),
        }

    def _dec_block_init(self, gen, dtype, dev):
        cfg = self.cfg
        return {
            "norm1": layernorm_init(cfg.d_model, dtype, dev),
            "self_attn": attention_init(gen, _attn_cfg(cfg, causal=True),
                                        dtype=dtype, device=dev),
            "norm2": layernorm_init(cfg.d_model, dtype, dev),
            "cross_attn": attention_init(gen, _attn_cfg(cfg, causal=False),
                                         dtype=dtype, device=dev),
            "norm3": layernorm_init(cfg.d_model, dtype, dev),
            "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                                 device=dev),
        }

    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Any:
        """Random parameters drawn in turn from ``gen``, each tensor moved
        to ``device`` (CUDA by default) as soon as it is drawn; each block
        is copied into the stacked leaves as it is drawn, so the peak stays
        near the parameters' bytes.  On ``"meta"`` nothing is drawn
        (``nn.module.no_draw``)."""
        dev = resolve_device(device)
        if dev.type == "meta":
            with no_draw():
                return self._init(gen, dev)
        return self._init(gen, dev)

    def _init(self, gen, dev):
        cfg = self.cfg
        dtype = cfg.torch_dtype
        params = {
            "embed": embedding_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                                    device=dev),
            "dec_pos": embedding_init(gen, self.max_target_positions,
                                      cfg.d_model, dtype=dtype, device=dev),
        }
        params["enc_scan"] = _draw_stacked(
            lambda: self._enc_block_init(gen, dtype, dev),
            cfg.n_encoder_layers)
        params["enc_norm"] = layernorm_init(cfg.d_model, dtype, dev)
        params["dec_scan"] = _draw_stacked(
            lambda: self._dec_block_init(gen, dtype, dev), cfg.n_layers)
        params["dec_norm"] = layernorm_init(cfg.d_model, dtype, dev)
        return params

    # --------------------------------------------------------------- encoder
    def encode(self, params, frame_embeds):
        """frame_embeds: (B, T, D) stub-frontend output -> (B, T, D)."""
        cfg = self.cfg
        T = frame_embeds.shape[1]
        x = frame_embeds.to(cfg.torch_dtype)
        x = x + sinusoidal_positions(T, cfg.d_model,
                                     device=x.device).to(x.dtype)
        acfg = _attn_cfg(cfg, causal=False)
        x = constrain_act(x)
        for p in _unstack(params["enc_scan"]):
            x = x + attention(p["attn"], acfg, layernorm(p["norm1"], x))
            x = constrain_act(x + gelu_mlp(p["mlp"],
                                           layernorm(p["norm2"], x)))
        return layernorm(params["enc_norm"], x)

    # --------------------------------------------------------------- decoder
    def _dec_positions(self, params, start, length, batch):
        # decoder position table is 448 long; positions wrap for the
        # long-context dry-run shapes (the reference's documented deviation)
        dev = params["dec_pos"]["embedding"].device
        pos = (torch.as_tensor(start, device=dev)
               + torch.arange(length, device=dev)) % self.max_target_positions
        return embed(params["dec_pos"], pos.expand(batch, length))

    def _dec_block(self, p, x, enc_out, acfg, xcfg):
        x = x + attention(p["self_attn"], acfg, layernorm(p["norm1"], x))
        x = x + cross_attention(p["cross_attn"], xcfg,
                                layernorm(p["norm2"], x), enc_out)
        return constrain_act(x + gelu_mlp(p["mlp"],
                                          layernorm(p["norm3"], x)))

    def decode_full(self, params, tokens, enc_out, *, long_ctx: bool = False,
                    remat: bool = False, last_only: bool = False):
        """Teacher-forced decoder pass.  Returns (logits, aux).  With
        ``remat`` each block is a ``torch.utils.checkpoint`` region (its
        activations recomputed in the backward pass); with ``last_only``
        the logits of the last position alone, (B, 1, V)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = embed(params["embed"], tokens)
        x = x + self._dec_positions(params, 0, S, B)
        acfg = _attn_cfg(cfg, causal=True, long_ctx=long_ctx)
        xcfg = _attn_cfg(cfg, causal=False)
        x = constrain_act(x)
        for p in _unstack(params["dec_scan"]):
            if remat:
                x = checkpoint(self._dec_block, p, x, enc_out, acfg, xcfg,
                               use_reentrant=False,
                               context_fn=checkpoint_context_fn())
            else:
                x = self._dec_block(p, x, enc_out, acfg, xcfg)
        if last_only:
            x = x[:, -1:]
        x = layernorm(params["dec_norm"], x)
        return unembed(params["embed"], x), {}

    def forward(self, params, tokens=None, *, frontend_embeds=None,
                long_ctx: bool = False, remat: bool = False,
                last_only: bool = False):
        enc_out = self.encode(params, frontend_embeds)
        return self.decode_full(params, tokens, enc_out, long_ctx=long_ctx,
                                remat=remat, last_only=last_only)

    def loss(self, params, batch, *, remat: bool = True):
        """Next-token cross-entropy of the teacher-forced decoder.  batch:
        tokens (B, S) integer and frontend_embeds (B, T, D).  Returns (ce,
        {"ce"}); ``remat`` changes no number."""
        logits, _ = self.forward(
            params, batch["tokens"],
            frontend_embeds=batch["frontend_embeds"], remat=remat)
        ce = softmax_cross_entropy(logits[:, :-1],
                                   batch["tokens"][:, 1:]).mean()
        return ce, {"ce": ce}

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        """Zero caches on ``device`` (CUDA by default), stacked on a leading
        decoder-layer axis: ``"self"`` {"k", "v"} of (L, batch, max_len,
        KV, D) and ``"cross"`` of (L, batch, n_frontend_tokens, KV, D)."""
        cfg = self.cfg
        dev = resolve_device(device)
        self_kv = init_kv_cache(_attn_cfg(cfg, causal=True), batch, max_len,
                                dtype, dev)
        shape = (batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.head_dim)
        cross = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        L = cfg.n_layers

        def stack(t):
            return tree_map(lambda x: x.new_zeros((L,) + x.shape), t)

        return {"self": stack(self_kv), "cross": stack(cross)}

    @torch.no_grad()
    def prefill_cross_cache(self, params, enc_out, caches):
        """Populate the cross-attention KV cache from the encoder output:
        each decoder layer's K and V of ``enc_out``, bf16 whatever the
        model's dtype (as in the reference), stacked as ``init_cache``
        stacks them; the self cache is passed through."""
        xcfg = _attn_cfg(self.cfg, causal=False)
        layers = _unstack(params["dec_scan"])
        B, T, _ = enc_out.shape
        shape = (len(layers), B, T, self.cfg.n_kv_heads, self.cfg.head_dim)
        cross = {n: torch.empty(shape, dtype=torch.bfloat16,
                                device=enc_out.device) for n in ("k", "v")}
        for i, p in enumerate(layers):
            k, v = cross_kv(p["cross_attn"], xcfg, enc_out)
            cross["k"][i].copy_(k)
            cross["v"][i].copy_(v)
        return {"self": caches["self"], "cross": cross}

    @torch.no_grad()
    def decode_step(self, params, token, caches, index, *,
                    long_ctx: bool = False):
        """One decoder token against the cached self and cross KV.

        token: (B, 1) integer; index: the position, a Python int or a 0-d
        integer tensor (keep it on the device to spare a copy a step).
        Returns (logits (B, 1, V), caches): inference, without autograd;
        every layer writes its self-KV row into ``caches`` in place
        (``nn.attention.decode_attention``), as ``DecoderModel.decode_step``
        does."""
        cfg = self.cfg
        B = token.shape[0]
        x = embed(params["embed"], token)
        index = torch.as_tensor(index, device=x.device)
        x = x + self._dec_positions(params, index, 1, B)
        acfg = _attn_cfg(cfg, causal=True, long_ctx=long_ctx)
        xcfg = _attn_cfg(cfg, causal=False)
        for p, self_c, k, v in zip(_unstack(params["dec_scan"]),
                                   _unstack(caches["self"]),
                                   caches["cross"]["k"].unbind(0),
                                   caches["cross"]["v"].unbind(0)):
            h, _ = decode_attention(p["self_attn"], acfg,
                                    layernorm(p["norm1"], x), self_c, index)
            x = x + h
            x = x + cross_attention(p["cross_attn"], xcfg,
                                    layernorm(p["norm2"], x),
                                    k=k.to(x.dtype), v=v.to(x.dtype))
            x = constrain_act(x + gelu_mlp(p["mlp"],
                                           layernorm(p["norm3"], x)))
        x = layernorm(params["dec_norm"], x)
        return unembed(params["embed"], x), caches


__all__ = ["WhisperModel"]
