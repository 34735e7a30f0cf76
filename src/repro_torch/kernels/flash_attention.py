"""Wrapper of K5, the port's flash-attention CUDA kernel
(``csrc/flash_attention.cu``), the counterpart of the reference's
``flash_attention`` / ``_flash_kernel``.

Given CPU tensors it computes with the kernel's plain PyTorch version
(``kernels.ref.attention_ref``).  Given CUDA tensors it launches the kernel
or raises; nothing falls back.  ``flash_attention.launches`` counts the
launches, a plain integer a run may reset and read.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (aligned, check_rc, launcher,
                                        on_one_device)
from repro_torch.kernels.ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P,) * 4 + (_I,) * 6 + (ctypes.c_float,) + (_I, _I, _P)


def flash_attention(q, k, v, *, causal: bool = True,
                    sliding_window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128):
    """q, k, v: (B, H, S, D) -> (B, H, S, D) in q's dtype.  GQA is the
    caller's: repeat the K/V heads before the call.

    f32 or bf16, all three of one dtype; D a multiple of 8 up to 256; any
    S.  ``block_q``/``block_k`` keep the reference's contract (S must be a
    multiple of ``min(block, S)``) and do not change the result: the
    kernel tiles by 64 and masks a ragged last tile itself.
    """
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    bq, bk = min(block_q, S), min(block_k, S)
    if bq < 1 or bk < 1 or S % bq or S % bk:
        raise ValueError(f"S={S} is not tiled by block_q={block_q} / "
                         f"block_k={block_k}")
    if D % 8 or not 0 < D <= 256:
        raise ValueError(f"head dim {D} must be a multiple of 8 up to 256")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    dev = on_one_device(q, k, v)
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal,
                             sliding_window=sliding_window)

    q, k, v = aligned(q), aligned(k), aligned(v)
    o = torch.empty_like(q)
    fn = launcher("flash_attention", "flash_attention_launch", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, S,
            D, int(causal), -1 if sliding_window is None else sliding_window,
            D ** -0.5, _DTYPE_CODES[q.dtype], dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    check_rc(rc, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


__all__ = ["flash_attention"]
