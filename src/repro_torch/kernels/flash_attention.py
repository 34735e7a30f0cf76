"""Wrapper of K5, the port's flash-attention CUDA kernel
(``csrc/flash_attention.cu``), the counterpart of the reference's
``flash_attention`` / ``_flash_kernel``.

Given CPU tensors it computes with the kernel's plain PyTorch version
(``kernels.ref.attention_ref``, on K/V heads repeated to H).  Given CUDA
tensors it launches the kernel or raises; nothing falls back.  Given
``meta`` tensors (the dry-run's, ``launch.dryrun``) it returns the output
the kernel would, empty, and launches nothing.  On CUDA and on ``meta``
it records the kernel's work (``repro_torch.costs.record``: its FLOPs
and the bytes it reads and writes) into any active cost counter, since a
ctypes launch bypasses the dispatcher.  The kernel has no backward
pass, so CUDA inputs that require grad (in grad mode) are refused.  Four
plain integers count what a run did, for a run to reset and read:
``flash_attention.launches`` (every launch), ``flash_attention.tc_launches``
(launches on the tensor-core route), ``flash_attention.dv_launches``
(launches whose values are narrower than the queries and keys, D_v != D:
multi-head latent attention) and ``flash_attention.copies`` (inputs the
kernel could not address in place and the wrapper copied).
"""
from __future__ import annotations

import array
import struct
from typing import Optional

import torch

from repro_torch.kernels._build import aligned, launch, on_one_device
from repro_torch.kernels.ref import attention_ref
from repro_torch.costs import attention_flops, record

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = struct.Struct("<f")
TC_MAX_D = 128   # the tensor-core route's widest head dim where D_v = D
# D_v != D (values narrower than queries and keys) runs on the tensor cores
# alone, in bf16, at D <= NARROW_V_MAX_D and D_v <= TC_MAX_D
NARROW_V_MAX_D = 192


def tensor_core_route(dtype: torch.dtype, head_dim: int,
                      v_dim: Optional[int] = None) -> bool:
    """Whether K5 runs on the tensor cores (wgmma) for this dtype, query
    and key head dim and value head dim (``head_dim`` when None): bf16 at
    D <= 128, and every D_v != D (which only bf16 at D <= 192, D_v <= 128
    may take: :func:`flash_attention` refuses the rest).  Everything else
    (f32 at any D, bf16 at 128 < D = D_v <= 256) runs on the CUDA cores.
    The kernel's C entry applies the same rule itself; this copy counts
    ``tc_launches``."""
    narrow_v = v_dim is not None and v_dim != head_dim
    return dtype == torch.bfloat16 and (head_dim <= TC_MAX_D or narrow_v)


def _addressable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place: a unit-stride
    last dim, and a base and every stride of a dim longer than 1 a
    positive multiple of 16 bytes.  Else an aligned contiguous copy,
    counted in ``flash_attention.copies``."""
    (n0, n1, n2, _), (s0, s1, s2, s3) = t.shape, t.stride()
    unit = 16 // t.element_size()
    if (s3 == 1 and t.data_ptr() % 16 == 0     # 0 on meta
            and (n0 == 1 or (s0 > 0 and s0 % unit == 0))
            and (n1 == 1 or (s1 > 0 and s1 % unit == 0))
            and (n2 == 1 or (s2 > 0 and s2 % unit == 0))):
        return t
    flash_attention.copies += 1
    return aligned(t)


def flash_attention(q, k, v, *, causal: bool = True,
                    sliding_window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128,
                    scale: Optional[float] = None):
    """q (B, H, S, D), k (B, H_kv, S, D) and v (B, H_kv, S, D_v) -> (B, H,
    S, D_v) in q's dtype.

    The scores q.k are scaled by ``scale`` (``D ** -0.5`` when None)
    before the softmax; the kernel takes the scale as an argument.  The
    values may be narrower than the queries and keys (D_v < D, multi-head
    latent attention's 192-wide query and key heads over 128-wide values):
    the kernel takes them in bf16 alone, at D <= 192 and D_v <= 128, on
    the tensor cores, and refuses anything else with D_v != D (the
    CUDA-core route takes D_v = D alone) on CUDA and ``meta``; the CPU's
    plain version computes any such pair.

    Query head h attends with KV head h // (H // H_kv) (grouped-query
    attention; H_kv = H is plain multi-head).  Any (B, H, S, D) view
    works, such as the transpose of a (B, S, H, D) projection: the kernel
    reads strides, and an input is copied only where it cannot be read in
    place (see ``_addressable``).  On CUDA the output is a (B, S, H, D)
    tensor returned as its (B, H, S, D) view, so transposing it back is
    free.

    f32 or bf16, all three of one dtype; D and D_v multiples of 8 up to
    256; any S.  The route depends on the dtype, D and D_v alone
    (``tensor_core_route``): bf16 at D <= 128 and every D_v != D run on
    the tensor cores (wgmma, TMA loads; D padded to 64, 128 or 192 with
    zeros, D_v to 64 or 128), the rest on the CUDA cores.
    ``block_q``/``block_k`` keep the reference's contract (S must be a
    multiple of ``min(block, S)``) and do not change the result: the
    kernel picks its own tiles and masks a ragged last tile itself.

    The checks read each tensor attribute once: at the served shape the
    call's host time is the kernel's cost.
    """
    qs, ks, vs = q.shape, k.shape, v.shape
    if len(qs) != 4 or len(ks) != 4 or len(vs) != 4 or ks[:3] != vs[:3]:
        raise ValueError(f"q must be (B, H, S, D), and k (B, H_kv, S, D) "
                         f"and v (B, H_kv, S, D_v) of one (B, H_kv, S) "
                         f"shape, got {tuple(qs)}, {tuple(ks)}, "
                         f"{tuple(vs)}")
    B, H, S, D = qs
    H_kv, Dv = ks[1], vs[3]
    if ks[0] != B or ks[2] != S or ks[3] != D:
        raise ValueError(f"k, v {tuple(ks)} must share q's batch, "
                         f"sequence and head dim {(B, S, D)}")
    if H_kv < 1 or H % H_kv:
        raise ValueError(f"{H} query heads are not a multiple of {H_kv} KV "
                         f"heads")
    bq, bk = min(block_q, S), min(block_k, S)
    if bq < 1 or bk < 1 or S % bq or S % bk:
        raise ValueError(f"S={S} is not tiled by block_q={block_q} / "
                         f"block_k={block_k}")
    if D % 8 or not 0 < D <= 256 or Dv % 8 or not 0 < Dv <= 256:
        raise ValueError(f"head dims {D}, {Dv} must be multiples of 8 up "
                         f"to 256")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    scale = D ** -0.5 if scale is None else float(scale)
    dt = q.dtype
    code = _DTYPE_CODES.get(dt)
    if code is None or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{dt}, {k.dtype}, {v.dtype}")
    dev = q.device
    if k.device != dev or v.device != dev:
        dev = on_one_device(q, k, v)         # raises, naming the devices
    if dev.type == "cpu":
        n_rep = H // H_kv
        return attention_ref(q, k.repeat_interleave(n_rep, dim=1),
                             v.repeat_interleave(n_rep, dim=1),
                             causal=causal, sliding_window=sliding_window,
                             scale=scale)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if Dv != D and not (dt == torch.bfloat16 and Dv < D <= NARROW_V_MAX_D
                        and Dv <= TC_MAX_D):
        raise ValueError(
            f"K5 takes values of another width than the queries and keys "
            f"(D_v {Dv}, D {D}, {dt}) only on its tensor-core route: bf16, "
            f"D_v < D <= {NARROW_V_MAX_D}, D_v <= {TC_MAX_D}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention: K5 has no backward pass (nor has the "
            "reference's kernel), and its output would carry no autograd "
            "history; compute a differentiable core with the eager "
            "branches (nn.attention.attention does so itself)")

    q, k, v = _addressable(q), _addressable(k), _addressable(v)
    # (B, S, H, D_v) storage seen as (B, H, S, D_v)
    o = torch.empty_strided((B, H, S, Dv), (S * H * Dv, Dv, H * Dv, 1),
                            dtype=dt, device=dev)
    record(attention_flops(B, H, S, S, D, causal=causal,
                           window=sliding_window, v_dim=Dv),
           (q.numel() + k.numel() + v.numel() + o.numel())
           * q.element_size())
    if dev.type == "meta":
        return o
    # enum Arg in csrc/flash_attention.cu; the scale as float32 bits
    args = array.array("q", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, H_kv, S, D, Dv, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], S * H * Dv, Dv, H * Dv, causal,
        -1 if sliding_window is None else sliding_window, code,
        int.from_bytes(_F32.pack(scale), "little")))
    launch("flash_attention", "flash_attention", dev, args)
    flash_attention.launches += 1
    flash_attention.tc_launches += tensor_core_route(dt, D, Dv)
    flash_attention.dv_launches += Dv != D
    return o


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.dv_launches = 0
flash_attention.copies = 0


__all__ = ["NARROW_V_MAX_D", "TC_MAX_D", "flash_attention",
           "tensor_core_route"]
