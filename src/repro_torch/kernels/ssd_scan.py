"""Wrapper of K8, the port's chunked SSD scan (``csrc/ssd_scan.cu``).

K8 replaces no TPU kernel: the reference's Mamba-2 layer
(``src/repro/nn/ssm.py``) is plain ``jnp``, and so is the port's plain
version, ``kernels.ref.ssd_chunked``.  It computes the same float32
mathematics as that version (the quadratic term within each chunk, the
chunk states, their recurrence, the incoming states' output, ``x D``)
without its redundant work and round trips to memory.

What bounds it on an H100: float32 operations on the CUDA cores (about
50 GFLOP a layer of granite-4.0-h at 4 x 2,048 steps, 0.75 ms at 67
TFLOP/s, against 0.1 ms for its inputs and outputs at 3.35 TB/s).  Every
product and sum is an f32 FFMA; no operand is rounded to TF32 or bf16.
The plain version copies B and C once per head, computes C B^T once per
head, and writes the (Q x Q) decays, scores and their product for every
head to memory and reads them back.  K8 reads x, B and C where the conv
left them (strided views of ``xBC``, bf16 or f32), computes C B^T once a
group of heads, and builds M = C B^T . exp(seg) . dt one 64 x 8 slice at
a time in shared memory, skipping the slices above the diagonal; no
(Q x Q) tensor of a head reaches device memory.

Each segment sum seg(q, k), the sum of dA over (k, q], is the float64
difference of a float64 cumulative sum rounded once to f32, never a
difference of f32 cumulative sums, which cancel (``ref._segsum``).

Given CPU tensors it computes with the plain version.  Given CUDA tensors
it launches the kernel or raises; nothing falls back.  Given ``meta``
tensors it returns the outputs, empty.  On CUDA and ``meta`` it records
its work (``repro_torch.costs.record``).  It has no backward pass.
``ssd_scan.launches`` counts the launches (four kernels each).
"""
from __future__ import annotations

import array

import torch

from repro_torch.costs import record
from repro_torch.kernels._build import aligned, launch, on_one_device
from repro_torch.kernels.ref import ssd_chunked

MAX_HEAD = 64      # P: the rows of a state tile
MAX_STATE = 128    # N: its columns
MAX_CHUNK = 256    # Q: a chunk's cumulative sums fit a block


def flops(b: int, S: int, H: int, G: int, P: int, N: int, Q: int, *,
          h0: bool = False) -> int:
    """Operations the chunked scan needs for these shapes: C B^T on and
    below the diagonal once a group, (C B^T . L . dt) x on and below it,
    every chunk's state, and the incoming state's output for every chunk
    but a first that starts from zeros; 2 a multiply-add."""
    c = S // Q
    tri = Q * (Q + 1) // 2
    return 2 * b * (c * G * tri * N + c * H * tri * P
                    + (2 * c - 1 + int(h0)) * H * Q * P * N)


def min_bytes(b: int, S: int, H: int, G: int, P: int, N: int, *,
              x_bytes: int = 2, h0: bool = False) -> int:
    """Bytes K8 must move at the least: x, B, C (``x_bytes`` an element)
    and the float32 dt read once, y written once in x's type, the float32
    final state written (and ``h0`` read) once."""
    return (b * S * (2 * H * P + 2 * G * N) * x_bytes + b * S * H * 4
            + (1 + int(h0)) * b * H * P * N * 4)


def _readable(t, inner: int):
    """``t`` (b, S, ., inner) as K8 reads it, 16 bytes at a time: unit
    stride inside a row of ``inner`` values, rows side by side, the base
    and the two outer strides whole 16 bytes; one aligned contiguous copy
    when it is not."""
    vec = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.stride(2) == inner and t.stride(0) % vec == 0
          and t.stride(1) % vec == 0 and t.data_ptr() % 16 == 0)
    return t if ok else aligned(t)


def ssd_scan(cfg, x, dt, A, B, C, D, *, h0=None):
    """The chunked SSD scan with ``kernels.ref.ssd_chunked``'s contract:
    x (b, S, H, P); dt (b, S, H) after the softplus; A (H,) negative; B, C
    (b, S, G, N); D (H,); h0 (b, H, P, N) or None; chunks of Q = min(
    ``cfg.chunk``, S) steps.  Returns (y, h_final): y (b, S, H, P) in x's
    type, computed in float32 and rounded once, h_final (b, H, P, N)
    float32.

    On CUDA: x, B and C all float32 or all bf16, each step's heads (or
    groups) side by side with unit stride (strided views of the conv's
    output are read in place); dt, A, D and h0 float32; P <= 64 and
    N <= 128, both multiples of 8; Q <= 256, H a multiple of G, S a
    multiple of Q.
    """
    b, S, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    Q = min(cfg.chunk, S)
    if (tuple(dt.shape) != (b, S, H) or tuple(B.shape) != (b, S, G, N)
            or tuple(C.shape) != (b, S, G, N) or tuple(A.shape) != (H,)
            or tuple(D.shape) != (H,)
            or (h0 is not None and tuple(h0.shape) != (b, H, P, N))):
        raise ValueError(
            f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, B "
            f"{tuple(B.shape)}, C {tuple(C.shape)}, A {tuple(A.shape)}, D "
            f"{tuple(D.shape)}, h0 {None if h0 is None else tuple(h0.shape)}"
            f" do not fit one (b, S, H, P, G, N)")
    if Q <= 0 or S % Q or H % G:
        raise ValueError(f"ssd_scan: S {S} must be a multiple of its chunk "
                         f"{Q} and H {H} of G {G}")
    dev = on_one_device(x, dt, A, B, C, D, h0) \
        if x.device.type != "meta" else x.device
    if dev.type == "cpu":
        y, h = ssd_chunked(cfg, x.float(), dt, A, B.float(), C.float(), D,
                           h0=h0)
        return y.to(x.dtype), h
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        raise RuntimeError("ssd_scan: K8 has no backward pass")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or B.dtype != x.dtype or C.dtype != x.dtype):
        raise TypeError(f"K8 takes x, B and C all float32 or all bf16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if any(t is not None and t.dtype != torch.float32
           for t in (dt, A, D, h0)):
        raise TypeError("K8 takes float32 dt, A, D and h0")
    if P > MAX_HEAD or N > MAX_STATE or P % 8 or N % 8 or Q > MAX_CHUNK:
        raise ValueError(f"K8 takes heads of at most {MAX_HEAD} and states "
                         f"of at most {MAX_STATE}, both multiples of 8, and "
                         f"chunks of at most {MAX_CHUNK} steps, got P={P}, "
                         f"N={N}, Q={Q}")
    c = S // Q
    if H > 65535 or b > 65535 or b * c * G > 65535:
        raise ValueError(f"K8's grid takes at most 65,535 heads, prompts "
                         f"and (prompt, chunk, group)s, got H={H}, b={b}, "
                         f"b*c*G={b * c * G}")
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=dev)
    h_final = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    record(flops(b, S, H, G, P, N, Q, h0=h0 is not None),
           min_bytes(b, S, H, G, P, N, x_bytes=x.element_size(),
                     h0=h0 is not None))
    if dev.type == "meta" or b == 0:
        return y, h_final
    x, B, C = _readable(x, P), _readable(B, N), _readable(C, N)
    dt, A, D = dt.contiguous(), A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    cs = torch.empty((b, c, H, Q), dtype=torch.float64, device=dev)
    dtq, wst, eo = (torch.empty((b, c, H, Q), **f32) for _ in range(3))
    decay = torch.empty((b, c, H), **f32)
    cb = torch.empty((b, c, G, Q, -(-Q // 8) * 8), **f32)  # rows padded
    hin = torch.empty((b, c, H, MAX_STATE, MAX_HEAD), **f32)
    # enum Arg in csrc/ssd_scan.cu
    args = array.array("q", (
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), cs.data_ptr(), dtq.data_ptr(),
        wst.data_ptr(), eo.data_ptr(), decay.data_ptr(), cb.data_ptr(),
        hin.data_ptr(), b, S, H, G, P, N, Q, x.stride(0), x.stride(1),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        int(x.dtype == torch.bfloat16)))
    launch("ssd_scan", "ssd_scan", dev, args)
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0


__all__ = ["MAX_CHUNK", "MAX_HEAD", "MAX_STATE", "flops", "min_bytes",
           "ssd_scan"]
