"""Decoder-only model composed from ArchConfig block patterns, as in
``repro.models.transformer``: init, the full-sequence forward, the
next-token loss, the split into an edge half and a server half, the KV
cache and one-token decode.

Layer weights are stacked per super-block (one repetition of
``cfg.pattern``) under ``params["scan"]``, each leaf with a leading
``n_pattern`` axis, exactly as the reference stacks them; a Python loop
over that axis takes the place of ``lax.scan``.  Each leaf is unbound
once into its super-blocks (``torch.unbind``), so a backward pass stacks
each leaf's gradient once instead of summing one zero-padded full-size
tensor a super-block.  Caches stack the same way under ``"scan"``.  The
lead blocks (``cfg.lead``, before the super-blocks, each with the dense MLP
of width ``cfg.d_ff_dense``: DeepSeek-V3's first dense layers) and the
remainder blocks are unrolled, under ``lead{i}_{kind}`` and
``rem{i}_{kind}``; a split puts the lead blocks on the edge.

A config's muP multipliers act here: the token embeddings times
``embedding_multiplier`` and the logits over ``logits_scaling``.  The split
halves mark the spans ``lm.edge`` and ``lm.server``
(``repro_torch.tracing``).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import (block_apply, block_decode, block_init,
                                       block_init_cache, norm_apply,
                                       norm_init)
from repro_torch.models.config import ArchConfig, as_port_config
from repro_torch.nn.constrain import (checkpoint_context_fn, constrain,
                                      constrain_act)
from repro_torch.nn.losses import softmax_cross_entropy
from repro_torch.nn.layers import dense, dense_init, embed, embedding_init, \
    unembed
from repro_torch.nn.module import no_draw, tree_map


def _seg_key(i: int, kind: str) -> str:
    return f"b{i}_{kind}"


def _n_segments(scan) -> int:
    """Length of the stacked leading axis of a ``"scan"`` subtree."""
    while isinstance(scan, dict):
        scan = next(iter(scan.values()))
    return scan.shape[0]


def _unstack(scan) -> list:
    """The super-blocks of a ``"scan"`` subtree: one ``torch.unbind`` per
    leaf (views; the backward of each is one ``stack``)."""
    n = _n_segments(scan)
    per_leaf = tree_map(lambda t: t.unbind(0), scan)
    return [tree_map(lambda u: u[s], per_leaf) for s in range(n)]


def _add(a, b):
    """a + b where None stands for "no term"."""
    return b if a is None else a if b is None else a + b


def _draw_stacked(draw, n: int):
    """``n`` trees from ``draw()``, in turn, stacked leaf by leaf on a new
    leading axis: each draw is copied into the stacked leaves and dropped,
    so the peak is the stack plus one tree."""
    first = draw()
    out = tree_map(lambda t: t.new_empty((n,) + t.shape), first)
    tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, t: o[i].copy_(t), out, draw())
    return out


class DecoderModel:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg = as_port_config(cfg)
        self.pattern = tuple(cfg.pattern)
        self.n_pattern = cfg.n_pattern
        self.remainder = tuple(cfg.remainder)
        self.lead = tuple(cfg.lead)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device: DeviceLike = None) -> Any:
        """Random parameters drawn in turn from ``gen``, each tensor moved
        to ``device`` (CUDA by default) as soon as it is drawn; each
        super-block is copied into the stacked leaves as it is drawn.  On
        ``"meta"`` nothing is drawn (``nn.module.no_draw``): the leaves
        have their shapes and dtypes and no storage."""
        dev = resolve_device(device)
        if dev.type == "meta":
            with no_draw():
                return self._init(gen, dev)
        return self._init(gen, dev)

    def _init(self, gen, dev):
        cfg = self.cfg
        dtype = cfg.torch_dtype

        def seg_init():
            return {_seg_key(i, kind): block_init(gen, cfg, kind, dtype, dev)
                    for i, kind in enumerate(self.pattern)}

        params = {"embed": embedding_init(gen, cfg.vocab, cfg.d_model,
                                          dtype=dtype, device=dev)}
        for i, kind in enumerate(self.lead):
            params[f"lead{i}_{kind}"] = block_init(gen, cfg, kind, dtype, dev,
                                                   dense=True)
        if self.n_pattern > 0:
            params["scan"] = _draw_stacked(seg_init, self.n_pattern)
        for i, kind in enumerate(self.remainder):
            params[f"rem{i}_{kind}"] = block_init(gen, cfg, kind, dtype, dev)
        params["final_norm"] = norm_init(cfg, dtype, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                           dtype=dtype, device=dev)
        return params

    # --------------------------------------------------------------- forward
    def _embed_tokens(self, params, tokens):
        x = embed(params["embed"], tokens)
        m = self.cfg.embedding_multiplier
        return x if m == 1.0 else x * m

    def _embed_inputs(self, params, tokens, frontend_embeds):
        parts = []
        if frontend_embeds is not None:
            parts.append(frontend_embeds.to(self.cfg.torch_dtype))
        if tokens is not None:
            parts.append(self._embed_tokens(params, tokens))
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def _super_apply(self, seg, x, long_ctx: bool):
        """One super-block (one repetition of ``cfg.pattern``).  Returns
        (x, the sum of its blocks' MoE auxiliary losses, None without an
        MoE block)."""
        aux = None
        for i, kind in enumerate(self.pattern):
            x, a = block_apply(seg[_seg_key(i, kind)], self.cfg, kind, x,
                               long_ctx=long_ctx)
            x = constrain_act(x)
            aux = _add(aux, a.get("moe_aux_loss"))
        return x, aux

    def _segments(self, x, scan, long_ctx: bool, remat: bool = False):
        """Run every stacked super-block of ``scan`` in order.  With
        ``remat`` each super-block is a ``torch.utils.checkpoint`` region
        (its activations recomputed in the backward pass).  Returns (x,
        the MoE auxiliary loss summed over the super-blocks, or None)."""
        aux = None
        for seg in _unstack(scan):
            if remat:
                x, a = checkpoint(self._super_apply, seg, x, long_ctx,
                                  use_reentrant=False,
                                  context_fn=checkpoint_context_fn())
            else:
                x, a = self._super_apply(seg, x, long_ctx)
            aux = _add(aux, a)
        return x, aux

    def _lead(self, params, x, long_ctx: bool):
        """The lead blocks on x (they hold no MoE, so no auxiliary loss)."""
        for i, kind in enumerate(self.lead):
            x, _ = block_apply(params[f"lead{i}_{kind}"], self.cfg, kind, x,
                               long_ctx=long_ctx)
        return x

    def _head(self, params, x):
        x = norm_apply(self.cfg, params["final_norm"], x)
        if self.cfg.tie_embeddings:
            logits = unembed(params["embed"], x)
        else:
            logits = dense(params["lm_head"], x)
        s = self.cfg.logits_scaling
        return logits if s == 1.0 else logits / s

    def _softcap(self, logits):
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        return logits

    def forward(self, params, tokens=None, *, frontend_embeds=None,
                long_ctx: bool = False, remat: bool = False,
                last_only: bool = False):
        """Full-sequence forward.  Returns (logits, aux); with
        ``last_only`` the logits of the last position alone, (B, 1, V) (the
        head runs on that position only: a prefill's next-token logits)."""
        x = constrain_act(self._embed_inputs(params, tokens, frontend_embeds))
        x = self._lead(params, x, long_ctx)
        aux = None
        if self.n_pattern > 0:
            x, aux = self._segments(x, params["scan"], long_ctx, remat)
        for i, kind in enumerate(self.remainder):
            x, a = block_apply(params[f"rem{i}_{kind}"], self.cfg, kind, x,
                               long_ctx=long_ctx)
            aux = _add(aux, a.get("moe_aux_loss"))
        if last_only:
            x = x[:, -1:]
        logits = constrain(self._softcap(self._head(params, x)),
                           ("batch", None, "model"))
        if aux is None:     # no MoE block
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, {"moe_aux_loss": aux}

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, *, remat: bool = True):
        """Next-token cross-entropy.  batch: tokens (B,S) integer, optional
        frontend_embeds (B,T,D); loss over token positions only.  Returns
        (total, {"ce", "moe_aux_loss"}); ``remat`` recomputes each
        super-block's activations in the backward pass and changes no
        number."""
        tokens = batch["tokens"]
        fe = batch.get("frontend_embeds")
        logits, aux = self.forward(params, tokens, frontend_embeds=fe,
                                   remat=remat)
        n_front = fe.shape[1] if fe is not None else 0
        # predict tokens[t+1] from sequence position n_front + t
        logits = logits[:, n_front:-1]
        targets = tokens[:, 1:]
        ce = softmax_cross_entropy(logits, targets).mean()
        total = ce + 0.01 * aux["moe_aux_loss"]
        return total, {"ce": ce, **aux}

    # ------------------------------------------------------------ split (§2)
    # The paper's technique: partition the network at a block boundary,
    # run the cheap half on the weak side of the link, transmit the
    # boundary activation (quantised by repro_torch.core.wire).  For the
    # assigned LLMs the boundary is a super-block index; the stacked
    # params slice cleanly (views, no copies).

    def split_params(self, params, n_edge_segments: int):
        """-> (edge_params, server_params) at a super-block boundary; the
        lead blocks go to the edge."""
        k = n_edge_segments
        lead = {kk: v for kk, v in params.items() if kk.startswith("lead")}
        edge = {"embed": params["embed"], **lead,
                "scan": tree_map(lambda t: t[:k], params["scan"])}
        server = {kk: v for kk, v in params.items()
                  if kk not in ("embed", "scan") and kk not in lead}
        server["scan"] = tree_map(lambda t: t[k:], params["scan"])
        if self.cfg.tie_embeddings:
            server["embed"] = params["embed"]
        return edge, server

    def edge_forward(self, params, tokens=None, *, frontend_embeds=None,
                     long_ctx: bool = False):
        """Embed + the lead blocks + the first n_edge super-blocks ->
        boundary hidden."""
        with tracing.span("lm.edge"):
            x = self._embed_inputs(params, tokens, frontend_embeds)
            x = self._lead(params, x, long_ctx)
            return self._segments(x, params["scan"], long_ctx)[0]

    def server_forward(self, params, hidden, *, long_ctx: bool = False,
                       last_only: bool = False):
        """Remaining super-blocks + remainder + head <- boundary hidden.
        As in the reference, no logit softcap is applied here.  With
        ``last_only`` the head runs on the last position alone: (B, 1, V),
        a prefill decision's next-token logits."""
        with tracing.span("lm.server"):
            x = hidden.to(self.cfg.torch_dtype)
            x = self._segments(x, params["scan"], long_ctx)[0]
            for i, kind in enumerate(self.remainder):
                x, _ = block_apply(params[f"rem{i}_{kind}"], self.cfg, kind,
                                   x, long_ctx=long_ctx)
            if last_only:
                x = x[:, -1:]
            return self._head(params, x)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: DeviceLike = None):
        """Zero caches on ``device`` (CUDA by default): the super-blocks'
        stacked under ``"scan"`` with a leading ``n_pattern`` axis, as the
        reference stacks them, the lead and remainder blocks' by name."""
        cfg = self.cfg
        dev = resolve_device(device)
        caches = {f"lead{i}_{kind}": block_init_cache(cfg, kind, batch,
                                                      max_len, dtype, dev)
                  for i, kind in enumerate(self.lead)}
        if self.n_pattern > 0:
            proto = {_seg_key(i, kind): block_init_cache(
                cfg, kind, batch, max_len, dtype, dev)
                for i, kind in enumerate(self.pattern)}
            caches["scan"] = tree_map(
                lambda t: t.new_zeros((self.n_pattern,) + t.shape), proto)
        for i, kind in enumerate(self.remainder):
            caches[f"rem{i}_{kind}"] = block_init_cache(cfg, kind, batch,
                                                        max_len, dtype, dev)
        return caches

    # ----------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, params, token, caches, index, *,
                    long_ctx: bool = False):
        """token: (B, 1) integer; index: the position, a Python int or a
        0-d integer tensor (keep it on the device to spare a copy a step).
        Returns (logits (B, 1, V), caches): inference, without autograd;
        every layer writes ``caches`` in place, its K/V row
        (``nn.attention.decode_attention``) or its recurrent state and conv
        buffer (``models.blocks.block_decode``)."""
        cfg = self.cfg
        x = constrain_act(self._embed_tokens(params, token))
        index = torch.as_tensor(index, device=x.device)
        for i, kind in enumerate(self.lead):
            k = f"lead{i}_{kind}"
            x, _ = block_decode(params[k], cfg, kind, x, caches[k], index,
                                long_ctx=long_ctx)
        if self.n_pattern > 0:
            for seg, seg_cache in zip(_unstack(params["scan"]),
                                      _unstack(caches["scan"])):
                for i, kind in enumerate(self.pattern):
                    k = _seg_key(i, kind)
                    x, _ = block_decode(seg[k], cfg, kind, x, seg_cache[k],
                                        index, long_ctx=long_ctx)
                    x = constrain_act(x)
        for i, kind in enumerate(self.remainder):
            k = f"rem{i}_{kind}"
            x, _ = block_decode(params[k], cfg, kind, x, caches[k], index,
                                long_ctx=long_ctx)
        return self._softcap(self._head(params, x)), caches


__all__ = ["DecoderModel"]
