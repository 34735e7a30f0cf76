"""Wrapper of K7, the port's grouped expert GEMM (``csrc/moe_grouped.cu``).

K7 replaces no TPU kernel: the reference's MoE runs its experts as one
batched einsum over capacity slots, which drops tokens.  A dropless MoE
(``nn.moe._moe_dropless``) sorts its (token, k) pairs by expert, so each
expert's rows lie contiguous, and K7 runs every expert's SwiGLU over its
own rows and no others: the gate|up GEMM fused with ``silu(gate) * up``,
then the down GEMM.

Given CPU tensors it computes with the plain version
(``kernels.ref.moe_grouped_ref``: per-expert ``torch.matmul``).  Given
CUDA tensors it launches the kernel or raises; nothing falls back.  Given
``meta`` tensors it returns the output, empty.  On CUDA and ``meta`` it
records its work (``repro_torch.costs.record``).  It has no backward
pass.  ``moe_grouped.launches`` counts the launches (two kernels each).
"""
from __future__ import annotations

import array

import torch

from repro_torch.costs import record
from repro_torch.kernels._build import launch, on_one_device
from repro_torch.kernels.ref import moe_grouped_ref

BLOCK_M = 128      # rows a tile: an expert's rows pad up to a multiple
GATE_N = 128       # hidden columns a tile of the gate|up GEMM
DOWN_N = 256       # output columns a tile of the down GEMM


def tiles_bound(rows: int, n_experts: int) -> int:
    """The most row tiles ``rows`` sorted rows over ``n_experts`` experts
    can need: each expert's last tile may be partial.  The kernels' grid,
    known without reading the offsets from the card; a tile past the
    experts' own exits at once."""
    return -(-rows // BLOCK_M) + n_experts


def flops(rows: int, d_model: int, d_ff: int) -> int:
    """Operations of ``rows`` routed rows: 2 D F each for gate, up and
    down."""
    return 6 * rows * d_model * d_ff


def min_bytes(rows: int, d_model: int, d_ff: int, n_experts: int,
              x_bytes: int = 2) -> int:
    """Bytes K7 must move at the least: the rows read once, every
    expert's three matrices read once, the float32 output written once."""
    return (rows * d_model * x_bytes + 3 * n_experts * d_model * d_ff
            * x_bytes + rows * d_model * 4)


def moe_grouped(x, offsets, w_gate, w_up, w_down, *, row_scale=None):
    """x (M, D) rows sorted by expert; ``offsets`` (E + 1,) int32 with
    expert e's rows ``x[offsets[e]:offsets[e + 1]]`` (``offsets[0]`` 0,
    ``offsets[E]`` M); w_gate, w_up (E, D, F) and w_down (E, F, D) as the
    MoE's stacked ``kernel``s.  Returns (M, D) float32: row r of expert e
    is ``row_scale[r] * (silu(x_r Wg_e) * (x_r Wu_e)) Wd_e`` (the scale 1
    where ``row_scale`` is None), the products summed in float32 and the
    hidden rounded once to x's dtype.

    On CUDA: bf16 x and weights, row_scale float32; D a multiple of 256,
    F of 128; every tensor contiguous.  The offsets are read on the card,
    so the call never waits for it.
    """
    M, D = x.shape
    E, D2, Fd = w_gate.shape
    if (D2 != D or tuple(w_up.shape) != (E, D, Fd)
            or tuple(w_down.shape) != (E, Fd, D)):
        raise ValueError(f"weights {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} do "
                         f"not fit rows of width {D}")
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"offsets {tuple(offsets.shape)} must be ({E + 1},)")
    if row_scale is not None and tuple(row_scale.shape) != (M,):
        raise ValueError(f"row_scale {tuple(row_scale.shape)} must be ({M},)")
    dev = on_one_device(x, offsets, w_gate, w_up, w_down, row_scale) \
        if x.device.type != "meta" else x.device
    if dev.type == "cpu":
        return moe_grouped_ref(x, offsets, w_gate, w_up, w_down, row_scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_gate, w_up, w_down, row_scale)):
        raise RuntimeError("moe_grouped: K7 has no backward pass")
    if (x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16
                                         for w in (w_gate, w_up, w_down))):
        raise TypeError(f"K7 takes bf16 rows and weights, got {x.dtype}, "
                        f"{w_gate.dtype}, {w_up.dtype}, {w_down.dtype}")
    if offsets.dtype != torch.int32 or (row_scale is not None
                                        and row_scale.dtype != torch.float32):
        raise TypeError("K7 takes int32 offsets and a float32 row_scale")
    if D % DOWN_N or Fd % GATE_N:
        raise ValueError(f"K7 needs D % {DOWN_N} == 0 and F % {GATE_N} == "
                         f"0, got D={D}, F={Fd}")
    for t in (x, offsets, w_gate, w_up, w_down, row_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("K7 takes contiguous tensors")
    out = torch.empty((M, D), dtype=torch.float32, device=dev)
    record(flops(M, D, Fd), min_bytes(M, D, Fd, E))
    if dev.type == "meta" or M == 0:
        return out
    hidden = torch.empty((M, Fd), dtype=torch.bfloat16, device=dev)
    # enum Arg in csrc/moe_grouped.cu
    args = array.array("q", (
        x.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), 0 if row_scale is None else row_scale.data_ptr(),
        M, D, Fd, E, tiles_bound(M, E)))
    launch("moe_grouped", "moe_grouped", dev, args)
    moe_grouped.launches += 1
    return out


moe_grouped.launches = 0


__all__ = ["BLOCK_M", "DOWN_N", "GATE_N", "flops", "min_bytes",
           "moe_grouped", "tiles_bound"]
