"""Multi-head self-attention with GQA, qk-norm, optional bias and sliding
windows, as in ``repro.nn.attention``: the full-sequence (training /
prefill) path.

Shapes follow the (B, S, H, D) convention internally; the public API takes
(B, S, d_model).  The full-sequence core goes through K5 (``kernels.
flash_attention``, causal or not) where :func:`flash_eligible` says so and
autograd will not need q, k and v (:func:`needs_autograd`: K5, like the
reference's kernel, has no backward pass), and through the reference's
two eager branches (``_scores_to_out``, ``chunked_attention``) otherwise.
The rule reads the config, the mask and autograd's state, never the
device, so the CPU takes the branch the card takes.  Cross-attention and
the one-token decode step over a KV cache are the reference's, eager.

The reference's sharding constraints sit at its places
(``nn.constrain.constrain``): they act only inside
``activation_sharding``, where the tensors are DTensors.  There K5 and
the chunked core take DTensor q, k and v through ``local_map``, each chip
running them on its own block, batch over the data axes and heads over
``"model"`` (:func:`_on_local_heads`); the chunked core's running max,
sum and accumulator are then the block's own, where the reference
constrains them to that layout.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.nn.constrain import (activation_spec, axis_sizes, constrain,
                                      is_dtensor, on_local_tensors, on_mesh,
                                      placements)
from repro_torch.nn.layers import dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.nn.module import tree_leaves
from repro_torch.nn.rotary import apply_rope

FLASH_BLOCK = 128   # K5's public tile where it divides S


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False          # qwen2.5 style
    qk_norm: bool = False           # qwen3 style (RMSNorm over head_dim)
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: Optional[int] = None  # None => full causal
    causal: bool = True             # False for encoder self-attention
    attn_logit_softcap: Optional[float] = None
    # the scores' softmax scale; None is head_dim ** -0.5 (granite-4.0-h's
    # attention_multiplier is 1/128)
    scale: Optional[float] = None
    # implementation knobs (not architecture):
    chunked_threshold: int = 2048   # S above which the online-softmax
                                    # chunked path replaces naive S^2 scores
    block_q: int = 512
    block_k: int = 512
    # decode with a sliding window gathers only the window from the cache
    # instead of masking the full S_max scores
    windowed_decode_gather: bool = False
    # skip fully-masked KV chunks in the chunked path (causal upper
    # triangle / outside the sliding-window band)
    skip_masked_blocks: bool = False
    # the reference's masked where() cache update (its form for a sharded
    # cache): no write at an out-of-range index, where the default clamps
    masked_cache_update: bool = False

    # fields the JAX package's dataclass lacks
    # (``models.config.port_only_dict``)
    PORT_ONLY: ClassVar[tuple] = ("scale",)

    @property
    def softmax_scale(self) -> float:
        return self.head_dim ** -0.5 if self.scale is None else self.scale


def attention_init(gen: torch.Generator, cfg: AttentionConfig, *,
                   dtype=torch.float32, device: DeviceLike = None):
    def proj(i, o, bias):
        return dense_init(gen, i, o, use_bias=bias, dtype=dtype,
                          device=device)

    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    p = {"wq": proj(cfg.d_model, qd, cfg.qkv_bias),
         "wk": proj(cfg.d_model, kvd, cfg.qkv_bias),
         "wv": proj(cfg.d_model, kvd, cfg.qkv_bias),
         "wo": proj(qd, cfg.d_model, False)}
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, dtype, device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, dtype, device)
    return p


def _project_qkv(params, cfg: AttentionConfig, x, positions):
    B, S, _ = x.shape
    q = dense(params["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = dense(params["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(params["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.use_rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    bshd = ("batch", None, "model", None)
    return constrain(q, bshd), constrain(k, bshd), constrain(v, bshd)


def _repeat_kv(x, n_rep: int):
    if n_rep == 1:
        return x
    B, S, KV, D = x.shape
    return x[:, :, :, None, :].expand(B, S, KV, n_rep, D).reshape(
        B, S, KV * n_rep, D)


def _scores_to_out(cfg, q, k, v, mask, *, seq_sharded: bool = False):
    """q: (B,Sq,H,D); k,v: (B,Skv,H_kv,D) with H a multiple of H_kv; mask
    broadcastable to (B,H,Sq,Skv).

    Query head h reads KV head h // (H // H_kv), the head ``_repeat_kv``
    would put there: the query heads are seen as H_kv groups, so k and v
    are never repeated (the reference passes them repeated, H_kv = H).
    ``seq_sharded`` pins the scores' KV axis to the "model" mesh axis
    (decode over a sequence-sharded cache), as the reference does."""
    B, Sq, H, D = q.shape
    G, Skv = k.shape[2], k.shape[1]
    scale = cfg.softmax_scale
    qg = q.reshape(B, Sq, G, H // G, D)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float() * scale
    logits = logits.reshape(B, H, Sq, Skv)
    if seq_sharded:
        logits = constrain(logits, ("batch", None, None, "model"))
    if cfg.attn_logit_softcap is not None:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    # the max is a constant to autograd, as the reference's stop_gradient
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m)
    probs = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    probs = probs.reshape(B, G, H // G, Sq, Skv)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v).reshape(B, Sq, H, D)


def make_attention_mask(cfg: AttentionConfig, q_len: int, kv_len: int,
                        q_offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,q_len,kv_len) boolean mask: True = attend."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if cfg.causal:
        mask &= kv_pos <= q_pos
    if cfg.sliding_window is not None:
        mask &= kv_pos > q_pos - cfg.sliding_window
    return mask[None, None]


def flash_eligible(cfg: AttentionConfig, mask) -> bool:
    """Whether a self-attention core goes through K5: no logit softcap and
    no caller mask.  Causal or not, at any length: the kernel masks a
    ragged last tile itself, and :func:`flash_blocks` keeps the wrapper's
    tiling contract."""
    return cfg.attn_logit_softcap is None and mask is None


def flash_blocks(S: int) -> int:
    """The ``block_q``/``block_k`` passed to K5 at length S: its public
    128 where that tiles S, else S itself.  The wrapper keeps the
    reference's contract (S a multiple of ``min(block, S)``), and its
    blocks do not change the result: the kernel picks its own tiles
    (``kernels.flash_attention.flash_attention``)."""
    return FLASH_BLOCK if S % FLASH_BLOCK == 0 else S


def needs_autograd(params, x) -> bool:
    """Whether autograd will need q, k and v: grad mode is on and ``x`` or
    a projection parameter requires grad (under ``torch.func.grad`` too).
    K5 has no backward pass, so such a core takes the eager branches, as
    the reference's always do."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(params)))


def _on_local_heads(fn, q, k, v, head_dim: int):
    """``fn(q, k, v)`` on each chip's block of DTensor q, k, v: batch
    over the data axes and heads (dim ``head_dim``) over "model" where
    they divide, through ``torch.distributed.tensor.experimental.
    local_map``; an attention core is independent across both, so the
    block needs no collective.  Where the query heads divide the model
    axis and the KV heads do not, k and v are first repeated to the query
    heads, so each chip holds the KV heads its query heads read."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    sizes = axis_sizes(mesh)
    dims = ["batch", None, None, None]
    dims[head_dim] = "model"
    spec = activation_spec(tuple(q.shape), dims, sizes, q.shape[0])
    H, H_kv = q.shape[head_dim], k.shape[head_dim]
    if spec[head_dim] is not None and H_kv % sizes["model"]:
        k = k.repeat_interleave(H // H_kv, dim=head_dim)
        v = v.repeat_interleave(H // H_kv, dim=head_dim)
    pl = placements(spec, mesh)

    def local(q, k, v):
        with on_local_tensors():    # constrain is the identity in here
            return fn(q, k, v)
    return local_map(local, out_placements=list(pl),
                     in_placements=(pl, pl, pl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def attention(params, cfg: AttentionConfig, x, *, positions=None,
              mask=None):
    """Full-sequence self-attention (training / prefill)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _project_qkv(params, cfg, x, positions)
    if flash_eligible(cfg, mask) and not needs_autograd(params, x):
        # K5 reads the (B, S, H, D) projections in place as (B, H, S, D)
        # views and maps each query head to its KV head; on the card its
        # output is (B, S, H, D) storage, so the reshape below is a view
        blk = flash_blocks(S)

        def core(q, k, v):
            return flash_attention(q, k, v, causal=cfg.causal,
                                   sliding_window=cfg.sliding_window,
                                   block_q=blk, block_k=blk,
                                   scale=cfg.scale)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        out = (_on_local_heads(core, q, k, v, 1) if is_dtensor(q)
               else core(q, k, v)).transpose(1, 2)
    elif S > cfg.chunked_threshold and mask is None:
        n_rep = cfg.n_heads // cfg.n_kv_heads
        k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)

        def core(q, k, v):
            return chunked_attention(cfg, q, k, v)
        out = (_on_local_heads(core, q, k, v, 2) if is_dtensor(q)
               else core(q, k, v))
    else:
        if mask is None:
            mask = make_attention_mask(cfg, S, S, device=x.device)

        def core(q, k, v):
            return _scores_to_out(cfg, q, k, v, mask)
        # on DTensors, each chip's block: DTensor's einsum flattens the
        # batch with a sharded head dim, which some releases refuse
        out = (_on_local_heads(core, q, k, v, 2) if is_dtensor(q)
               else core(q, k, v))
    out = constrain(out, ("batch", None, "model", None))
    return dense(params["wo"], out.reshape(B, S, -1))


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (eager "flash"): never materialises the
# (S, S) score matrix.  The reference's path above ``chunked_threshold``;
# K5 computes the same function where ``flash_eligible`` holds.
# ---------------------------------------------------------------------------

_NEG = -0.5 * float(torch.finfo(torch.float32).max)


def _chunk_q_block(cfg: AttentionConfig, q_blk, k, v, q_lo: int,
                   kv_lo: int = 0):
    """One q-chunk against the given KV range with an online softmax.

    q_blk: (B, bq, H, D); k, v: (B, Skv', H, D) (a slice starting at global
    position ``kv_lo``); q_lo: first query position.
    """
    B, bq, H, D = q_blk.shape
    Skv = k.shape[1]
    bk = min(cfg.block_k, Skv)
    n_k = Skv // bk
    scale = cfg.softmax_scale
    qf = q_blk.float() * scale
    q_pos = q_lo + torch.arange(bq, device=q_blk.device)
    m = constrain(torch.full((B, H, bq), _NEG, dtype=torch.float32,
                             device=q_blk.device), ("batch", "model", None))
    l = constrain(torch.zeros((B, H, bq), dtype=torch.float32,
                              device=q_blk.device), ("batch", "model", None))
    acc = constrain(torch.zeros((B, H, bq, D), dtype=torch.float32,
                                device=q_blk.device),
                    ("batch", "model", None, None))
    for ik in range(n_k):
        k_blk = k[:, ik * bk:(ik + 1) * bk]
        v_blk = v[:, ik * bk:(ik + 1) * bk]
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())
        if cfg.attn_logit_softcap is not None:
            c = cfg.attn_logit_softcap
            logits = c * torch.tanh(logits / c)
        kv_pos = kv_lo + ik * bk + torch.arange(bk, device=q_blk.device)
        msk = torch.ones((bq, bk), dtype=torch.bool, device=q_blk.device)
        if cfg.causal:
            msk &= kv_pos[None, :] <= q_pos[:, None]
        if cfg.sliding_window is not None:
            msk &= kv_pos[None, :] > q_pos[:, None] - cfg.sliding_window
        logits = torch.where(msk[None, None], logits, _NEG)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - new_m[..., None]) * msk[None, None]
        alpha = torch.exp(m - new_m)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m = new_m
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)                 # (B, bq, H, D)


def chunked_attention(cfg: AttentionConfig, q, k, v):
    """q, k, v: (B, S, H, D) (kv already GQA-repeated) -> (B, S, H, D).

    Every q-chunk visits every KV chunk (the mask kills the upper
    triangle); with ``cfg.skip_masked_blocks`` each q-chunk visits only
    the KV chunks its causal / sliding-window band reaches.
    """
    B, S, H, D = q.shape
    bq = min(cfg.block_q, S)
    bk = min(cfg.block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"S={S} not tiled by block_q={bq} / block_k={bk}")
    outs = []
    for iq in range(S // bq):
        q_lo = iq * bq
        lo, hi = 0, S // bk
        if cfg.skip_masked_blocks:
            if cfg.sliding_window is not None:
                lo = max(q_lo - cfg.sliding_window + 1, 0) // bk
            if cfg.causal:
                hi = min((q_lo + bq - 1) // bk + 1, S // bk)
        outs.append(_chunk_q_block(cfg, q[:, q_lo:q_lo + bq],
                                   k[:, lo * bk:hi * bk],
                                   v[:, lo * bk:hi * bk], q_lo, lo * bk))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Cross attention (Whisper decoder)
# ---------------------------------------------------------------------------

def cross_attention(params, cfg: AttentionConfig, x, kv_src=None, *,
                    k=None, v=None):
    """kv_src: (B, S_enc, d_model) encoder output (no rope, no mask), or
    precomputed k/v (decode path reuses cached cross-KV)."""
    B, Sq, _ = x.shape
    q = dense(params["wq"], x).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
    if k is None:
        k, v = cross_kv(params, cfg, kv_src)
    out = _scores_to_out(cfg, q, k, v, None)
    return dense(params["wo"], out.reshape(B, Sq, -1))


def cross_kv(params, cfg: AttentionConfig, kv_src):
    B, Skv, _ = kv_src.shape
    k = dense(params["wk"], kv_src).reshape(B, Skv, cfg.n_kv_heads,
                                            cfg.head_dim)
    v = dense(params["wv"], kv_src).reshape(B, Skv, cfg.n_kv_heads,
                                            cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(params["k_norm"], k)
    return k, v


# ---------------------------------------------------------------------------
# Decode path with KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: AttentionConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device: DeviceLike = None):
    """{"k", "v"} of (batch, max_len, KV, D) zeros, bf16 by default (for
    an f32 model too, as in the reference), on ``device`` (CUDA by
    default)."""
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _write_row_sharded(k_cache, v_cache, k_row, v_row, idx, masked: bool):
    """The new K/V row written into DTensor caches (B, S_max, KV, D) in
    place, each chip writing its own block (``local_map``): a chip whose
    sequence range [lo, lo + S_local) holds the row's position writes it
    there, the others write back the row they hold.  The position is the
    index clamped to [0, S_max - 1], or with ``masked`` the index itself,
    written nowhere when out of range, as the unsharded write does."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    S_max = k_cache.shape[1]
    pl = list(k_cache.placements)
    seq = [d for d, p in enumerate(pl) if p.is_shard(1)]
    row_pl = [Replicate() if p.is_shard(1) else p for p in pl]

    def write(kc, vc, kr, vr, i):
        chunk = 0                  # this chip's sequence block, outer first
        for d in seq:
            chunk = chunk * mesh.size(d) + mesh.get_local_rank(d)
        S_local = kc.shape[1]
        r = (i if masked else i.clamp(0, S_max - 1)) - chunk * S_local
        mine = (r >= 0) & (r < S_local)
        r = r.clamp(0, S_local - 1).reshape(1)
        for c, new in ((kc, kr), (vc, vr)):
            c.index_copy_(1, r, torch.where(mine, new, c.index_select(1, r)))

    local_map(write, out_placements=None,
              in_placements=(pl, pl, row_pl, row_pl,
                             [Replicate()] * mesh.ndim),
              device_mesh=mesh, redistribute_inputs=True)(
        k_cache, v_cache, k_row, v_row, idx)


@torch.no_grad()
def decode_attention(params, cfg: AttentionConfig, x, cache, index):
    """One-token decode step.

    x: (B, 1, d_model); cache: {"k","v"} of (B, S_max, KV, D); index: the
    position of the new token, a Python int, a 0-d integer tensor or a
    ``(B,)`` one (which must hold one element: as in the reference, the
    rope positions take it per row but a single index writes the cache).
    Returns (out, cache).

    Decode is inference: it runs without autograd and writes the new K/V
    row into ``cache`` in place (the reference returns a new cache; a
    copy a token would move the whole cache).  Like the reference's
    dynamic update slice, the write clamps the row to [0, S_max - 1];
    with ``masked_cache_update`` (the reference's where() over every
    position) it writes the row whose position equals ``index``, none when
    it is out of range, touching that one row.  The index stays on the
    device: nothing here reads it on the host.
    """
    B, S1, _ = x.shape
    assert S1 == 1, "decode_attention processes exactly one new token"
    index = torch.as_tensor(index, device=x.device)
    positions = (index.reshape(1, 1).expand(B, 1) if index.dim() == 0
                 else index.reshape(B, 1))
    q, k_new, v_new = _project_qkv(params, cfg, x, positions.to(torch.int32))
    # the one token's q/k/v are replicated over "model", so they compose
    # with however the cache is sharded
    rep = ("batch", None, None, None)
    q, k_new, v_new = constrain(q, rep), constrain(k_new, rep), \
        constrain(v_new, rep)

    idx = index.to(torch.int64).reshape(())
    k_cache, v_cache = cache["k"], cache["v"]
    S_max = k_cache.shape[1]
    row = idx.clamp(0, S_max - 1).reshape(1)
    k_row, v_row = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    if is_dtensor(k_cache):
        _write_row_sharded(k_cache, v_cache, k_row, v_row, idx,
                           cfg.masked_cache_update)
    else:
        if cfg.masked_cache_update:
            # the reference's where() over every position writes the row at
            # ``index`` and none when it is out of range: the same function,
            # computed on the one row the write can touch
            inside = (idx >= 0) & (idx < S_max)
            k_row = torch.where(inside, k_row, k_cache.index_select(1, row))
            v_row = torch.where(inside, v_row, v_cache.index_select(1, row))
        k_cache.index_copy_(1, row, k_row)
        v_cache.index_copy_(1, row, v_row)

    if (cfg.windowed_decode_gather and cfg.sliding_window is not None
            and S_max > cfg.sliding_window):
        # read only the live window from the cache instead of scoring
        # (and masking) all S_max cached positions
        W = cfg.sliding_window
        start = (idx - W + 1).clamp(0, S_max - W)
        kv_pos = start + torch.arange(W, device=x.device)
        k_cmp = k_cache.index_select(1, kv_pos)
        v_cmp = v_cache.index_select(1, kv_pos)
    else:
        k_cmp, v_cmp = k_cache, v_cache
        kv_pos = torch.arange(S_max, device=x.device)
    valid = kv_pos <= idx
    if cfg.sliding_window is not None:
        valid &= kv_pos > idx - cfg.sliding_window
    mask = valid[None, None, None, :]  # (1,1,1,S_kv)

    # the query heads read their KV heads in groups (_scores_to_out): the
    # cache is never repeated to H heads
    out = _decode_scores(cfg, q, k_cmp.to(q.dtype), v_cmp.to(q.dtype), mask,
                         seq_sharded=cfg.masked_cache_update)
    return dense(params["wo"], out.reshape(B, 1, -1)), cache


def _decode_scores(cfg, q, k, v, mask, *, seq_sharded: bool):
    """``_scores_to_out`` of the one-token step.  On DTensors over a cache
    that keeps its sequence whole on each chip, each chip scores its own
    block (``local_map``: batch over the data axes, the KV heads and
    their query heads over "model" where both divide): the grouped
    scores' einsum flattens the batch with the KV-head dim, which DTensor
    refuses while that dim is sharded.  A sequence-sharded cache keeps
    the reference's DTensor form, its scores' KV axis over "model"."""
    if not is_dtensor(k) or any(p.is_shard(1) for p in k.placements):
        return _scores_to_out(cfg, q, k, v, mask, seq_sharded=seq_sharded)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    sizes = axis_sizes(mesh)
    heads = q.shape[2] % sizes["model"] == 0 and \
        k.shape[2] % sizes["model"] == 0
    dims = ("batch", None, "model" if heads else None, None)
    q_pl = placements(activation_spec(tuple(q.shape), dims, sizes,
                                      q.shape[0]), mesh)
    kv_pl = placements(activation_spec(tuple(k.shape), dims, sizes,
                                       k.shape[0]), mesh)

    def local(q, k, v, m):
        with on_local_tensors():
            return _scores_to_out(cfg, q, k, v, m)
    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl,
                                    [Replicate()] * mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, on_mesh(mask, mesh))


__all__ = ["AttentionConfig", "attention", "attention_init",
           "chunked_attention", "cross_attention", "cross_kv",
           "decode_attention", "flash_blocks", "flash_eligible",
           "init_kv_cache", "make_attention_mask", "needs_autograd"]
