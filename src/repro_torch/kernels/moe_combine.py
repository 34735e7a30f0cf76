"""Wrapper of K9, the dropless MoE's combine (``csrc/moe_combine.cu``).

K9 replaces no TPU kernel: the reference's MoE combines capacity slots by
a one-hot einsum.  The dropless route (``nn.moe._moe_dropless``) sorts its
(token, k) pairs by expert and K7 computes each pair's gate-scaled output
at the pair's sorted row; K9 gathers each token's K rows back, sums them
in float32 in the order k = 0..K-1, adds the shared expert's row and
rounds once to the layer's type.

What bounds it on an H100: bytes, K7's float32 rows read once (1.342 GB a
layer of granite-4.0-h at 8,192 tokens, top-10, D 4,096), the shared rows
read and the result written once (67 MB each): 0.44 ms at 3.35 TB/s.

Given CPU tensors it computes with the plain version
(``kernels.ref.moe_combine_ref``, differentiable).  Given CUDA tensors it
launches the kernel or raises; nothing falls back.  Given ``meta`` tensors
it returns the output, empty.  On CUDA and ``meta`` it records its work
(``repro_torch.costs.record``).  It has no backward pass.
``moe_combine.launches`` counts the launches.
"""
from __future__ import annotations

import array

import torch

from repro_torch.costs import record
from repro_torch.kernels._build import launch, on_one_device
from repro_torch.kernels.ref import moe_combine_ref

MAX_TOP_K = 16     # K: a token's rows sit in registers, K a template argument
COLS = 8           # D: a thread's 8 columns, one 16-byte store of bf16


def flops(T: int, K: int, D: int, *, shared: bool = True) -> int:
    """Additions of the combine: K - 1 a column of a token, one more for
    the shared row."""
    return T * D * (K - 1 + int(shared))


def min_bytes(T: int, K: int, D: int, *, shared: bool = True,
              y_bytes: int = 2) -> int:
    """Bytes K9 must move at the least: the T K float32 rows and their
    int32 positions read once, the shared rows read (in the output's type)
    and the output written once."""
    return T * K * (D * 4 + 4) + (1 + int(shared)) * T * D * y_bytes


def moe_combine(out, pos, shared=None, *, dtype):
    """out (M, D) float32, the gate-scaled output of each sorted (token, k)
    pair; pos (T, K) int32, the sorted row of pair (t, k), each in [0, M);
    shared (T, D) or None.  Returns (T, D) of ``dtype``: row t is
    ``sum_k out[pos[t, k]] + float(shared[t])`` in float32, rounded once.

    On CUDA: bf16 ``dtype`` and shared, 1 <= K <= 16, D a multiple of 8,
    every tensor contiguous at a 16-byte aligned base.  The positions are
    not checked against M (that would wait for the card).
    """
    if out.dim() != 2 or pos.dim() != 2:
        raise ValueError(f"moe_combine: out {tuple(out.shape)} must be "
                         f"(M, D) and pos {tuple(pos.shape)} (T, K)")
    (M, D), (T, K) = out.shape, pos.shape
    if shared is not None and tuple(shared.shape) != (T, D):
        raise ValueError(f"moe_combine: shared {tuple(shared.shape)} must "
                         f"be ({T}, {D})")
    dev = on_one_device(out, pos, shared) \
        if out.device.type != "meta" else out.device
    if dev.type == "cpu":
        return moe_combine_ref(out, pos, shared, dtype=dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (out, shared)):
        raise RuntimeError("moe_combine: K9 has no backward pass")
    if (out.dtype != torch.float32 or pos.dtype != torch.int32
            or dtype != torch.bfloat16
            or (shared is not None and shared.dtype != torch.bfloat16)):
        raise TypeError(f"K9 takes float32 rows, int32 positions and a bf16 "
                        f"shared row and output, got {out.dtype}, "
                        f"{pos.dtype}, "
                        f"{None if shared is None else shared.dtype}, "
                        f"{dtype}")
    if not 1 <= K <= MAX_TOP_K or D % COLS or (T and not M):
        raise ValueError(f"K9 takes 1 to {MAX_TOP_K} rows a token and D a "
                         f"multiple of {COLS}, got K={K}, D={D}, M={M}")
    for t in (out, pos, shared):
        if t is not None and (not t.is_contiguous()
                              or (dev.type == "cuda"
                                  and t.data_ptr() % 16)):
            raise ValueError("K9 takes contiguous tensors at 16-byte "
                             "aligned bases")
    y = torch.empty((T, D), dtype=dtype, device=dev)
    record(flops(T, K, D, shared=shared is not None),
           min_bytes(T, K, D, shared=shared is not None))
    if dev.type == "meta" or T == 0:
        return y
    # enum Arg in csrc/moe_combine.cu
    args = array.array("q", (
        out.data_ptr(), pos.data_ptr(),
        0 if shared is None else shared.data_ptr(), y.data_ptr(),
        T, K, M, D))
    launch("moe_combine", "moe_combine", dev, args)
    moe_combine.launches += 1
    return y


moe_combine.launches = 0


__all__ = ["COLS", "MAX_TOP_K", "flops", "min_bytes", "moe_combine"]
