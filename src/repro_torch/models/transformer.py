"""Decoder-only model composed from ArchConfig block patterns, as in
``repro.models.transformer``: init, the full-sequence forward, and the
split into an edge half and a server half.

Layer weights are stacked per super-block (one repetition of
``cfg.pattern``) under ``params["scan"]``, each leaf with a leading
``n_pattern`` axis, exactly as the reference stacks them; a Python loop
over that axis takes the place of ``lax.scan``.  The remainder blocks are
unrolled.  The loss, the KV cache and decode wait (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import (block_apply, block_init, norm_apply,
                                       norm_init)
from repro_torch.models.config import ArchConfig
from repro_torch.nn.layers import dense, dense_init, embed, embedding_init, \
    unembed
from repro_torch.nn.module import tree_map


def _seg_key(i: int, kind: str) -> str:
    return f"b{i}_{kind}"


def _n_segments(scan) -> int:
    """Length of the stacked leading axis of a ``"scan"`` subtree."""
    while isinstance(scan, dict):
        scan = next(iter(scan.values()))
    return scan.shape[0]


def _stack(trees: list):
    """Stack a list of same-shaped nested dicts leaf by leaf (axis 0)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class DecoderModel:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.pattern = tuple(cfg.pattern)
        self.n_pattern = cfg.n_pattern
        self.remainder = tuple(cfg.remainder)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Any:
        """Random parameters drawn in turn from ``gen``, each tensor moved
        to ``device`` (CUDA by default) as soon as it is drawn."""
        cfg = self.cfg
        dtype = cfg.torch_dtype
        dev = resolve_device(device)

        def seg_init():
            return {_seg_key(i, kind): block_init(gen, cfg, kind, dtype, dev)
                    for i, kind in enumerate(self.pattern)}

        params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model,
                                          dtype=dtype, device=dev)}
        if self.n_pattern > 0:
            params["scan"] = _stack([seg_init()
                                     for _ in range(self.n_pattern)])
        for i, kind in enumerate(self.remainder):
            params[f"rem{i}_{kind}"] = block_init(gen, cfg, kind, dtype, dev)
        params["final_norm"] = norm_init(cfg, dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                           dtype=dtype, device=dev)
        return params

    # --------------------------------------------------------------- forward
    def _embed_inputs(self, params, tokens, frontend_embeds):
        parts = []
        if frontend_embeds is not None:
            parts.append(frontend_embeds.to(self.cfg.torch_dtype))
        if tokens is not None:
            parts.append(embed(params["embed"], tokens))
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def _segments(self, x, scan, long_ctx: bool):
        """Run every stacked super-block of ``scan`` in order."""
        for s in range(_n_segments(scan)):
            seg = tree_map(lambda t: t[s], scan)
            for i, kind in enumerate(self.pattern):
                x, _ = block_apply(seg[_seg_key(i, kind)], self.cfg, kind, x,
                                   long_ctx=long_ctx)
        return x

    def _head(self, params, x):
        x = norm_apply(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return unembed(params["embed"], x)
        return dense(params["lm_head"], x)

    def forward(self, params, tokens=None, *, frontend_embeds=None,
                long_ctx: bool = False):
        """Full-sequence forward.  Returns (logits, aux)."""
        x = self._embed_inputs(params, tokens, frontend_embeds)
        if self.n_pattern > 0:
            x = self._segments(x, params["scan"], long_ctx)
        for i, kind in enumerate(self.remainder):
            x, _ = block_apply(params[f"rem{i}_{kind}"], self.cfg, kind, x,
                               long_ctx=long_ctx)
        logits = self._head(params, x)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        # no MoE block is ported, so the auxiliary loss is zero
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, {"moe_aux_loss": aux}

    # ------------------------------------------------------------ split (§2)
    # The paper's technique: partition the network at a block boundary,
    # run the cheap half on the weak side of the link, transmit the
    # boundary activation (quantised by repro_torch.core.wire).  For the
    # assigned LLMs the boundary is a super-block index; the stacked
    # params slice cleanly (views, no copies).

    def split_params(self, params, n_edge_segments: int):
        """-> (edge_params, server_params) at a super-block boundary."""
        k = n_edge_segments
        edge = {"embed": params["embed"],
                "scan": tree_map(lambda t: t[:k], params["scan"])}
        server = {kk: v for kk, v in params.items()
                  if kk not in ("embed", "scan")}
        server["scan"] = tree_map(lambda t: t[k:], params["scan"])
        if self.cfg.tie_embeddings:
            server["embed"] = params["embed"]
        return edge, server

    def edge_forward(self, params, tokens=None, *, frontend_embeds=None,
                     long_ctx: bool = False):
        """Embed + the first n_edge super-blocks -> boundary hidden."""
        x = self._embed_inputs(params, tokens, frontend_embeds)
        return self._segments(x, params["scan"], long_ctx)

    def server_forward(self, params, hidden, *, long_ctx: bool = False):
        """Remaining super-blocks + remainder + head <- boundary hidden.
        As in the reference, no logit softcap is applied here."""
        x = hidden.to(self.cfg.torch_dtype)
        x = self._segments(x, params["scan"], long_ctx)
        for i, kind in enumerate(self.remainder):
            x, _ = block_apply(params[f"rem{i}_{kind}"], self.cfg, kind, x,
                               long_ctx=long_ctx)
        return self._head(params, x)


__all__ = ["DecoderModel"]
