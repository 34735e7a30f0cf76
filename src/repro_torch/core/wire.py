"""Wire codecs for the split boundary (port of ``repro.core.wire``).

The paper transmits the on-device encoder's K-channel feature map as an
uncompressed uint8 buffer.  A payload is a dict of tensors; on equal float
inputs every codec here writes the same bytes as the reference's
(``torch.round`` and ``jnp.round`` both round half to even).

``encode_batch`` quantises PER EXAMPLE: where the reference vmaps
``encode`` over the leading axis, the port reduces over every axis but the
first, so each request's payload is the one the single-frame path writes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

Payload = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Base: float32 passthrough."""

    name: str = "float32"
    itemsize: float = 4.0
    overhead_bytes_per_tensor: int = 0

    def encode(self, x: torch.Tensor) -> Payload:
        return {"data": x.to(torch.float32)}

    def decode(self, payload: Payload, dtype=torch.float32) -> torch.Tensor:
        return payload["data"].to(dtype)

    def wire_bytes(self, shape: tuple) -> int:
        return math.prod(shape) * int(self.itemsize) + \
            self.overhead_bytes_per_tensor

    def wire_bits(self, shape: tuple) -> int:
        return 8 * self.wire_bytes(shape)

    # ---- batched serving ---------------------------------------------------
    def encode_batch(self, x: torch.Tensor) -> Payload:
        """Encode a stacked batch with PER-EXAMPLE quantisation parameters.

        The passthrough codecs have none, so this is ``encode``."""
        return self.encode(x)

    def decode_batch(self, payload: Payload, dtype=torch.float32):
        return self.decode(payload, dtype)

    def wire_bytes_batch(self, shape: tuple, batch: int) -> int:
        """Exact link bytes of a ``batch``-request micro-batch (each
        request carries its own quantisation header)."""
        return batch * self.wire_bytes(shape)


@dataclasses.dataclass(frozen=True)
class BF16Codec(WireCodec):
    name: str = "bf16"
    itemsize: float = 2.0

    def encode(self, x):
        return {"data": x.to(torch.bfloat16)}


def _per_example(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a (B,) header against a (B, ...) tensor of ``ndim`` dims."""
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


@dataclasses.dataclass(frozen=True)
class Uint8AffineCodec(WireCodec):
    """Per-tensor affine quantisation to uint8 (the paper's wire format for
    features in [0,1]; scale/zero travel as an 8-byte header)."""

    name: str = "uint8"
    itemsize: float = 1.0
    overhead_bytes_per_tensor: int = 8

    @staticmethod
    def _quantise(xf, lo, hi):
        scale = torch.clamp(hi - lo, min=1e-8) / 255.0
        q = torch.clamp(torch.round((xf - _per_example(lo, xf.ndim))
                                    / _per_example(scale, xf.ndim)), 0, 255)
        return {"data": q.to(torch.uint8), "scale": scale, "zero": lo}

    def encode(self, x):
        xf = x.to(torch.float32)
        return self._quantise(xf, xf.min(), xf.max())

    def encode_batch(self, x):
        xf = x.to(torch.float32)
        flat = xf.reshape(xf.shape[0], -1)
        return self._quantise(xf, flat.amin(1), flat.amax(1))

    def decode(self, payload, dtype=torch.float32):
        d = payload["data"]
        return (d.to(torch.float32) * _per_example(payload["scale"], d.ndim)
                + _per_example(payload["zero"], d.ndim)).to(dtype)

    decode_batch = decode


@dataclasses.dataclass(frozen=True)
class Int8ChannelCodec(WireCodec):
    """Per-channel (last axis) symmetric int8 — used for transformer hidden
    states at the pod boundary, where per-channel scales matter."""

    name: str = "int8_channel"
    itemsize: float = 1.0

    @staticmethod
    def _quantise(xf, dims):
        amax = torch.amax(torch.abs(xf), dim=dims, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return {"data": q, "scale": scale}

    def encode(self, x):
        xf = x.to(torch.float32)
        return self._quantise(xf, tuple(range(xf.ndim - 1)))

    def encode_batch(self, x):
        xf = x.to(torch.float32)
        return self._quantise(xf, tuple(range(1, xf.ndim - 1)))

    def decode(self, payload, dtype=torch.float32):
        return (payload["data"].to(torch.float32)
                * payload["scale"]).to(dtype)

    decode_batch = decode

    def wire_bytes(self, shape):
        return math.prod(shape) + 4 * shape[-1]


CODECS: dict[str, WireCodec] = {
    "float32": WireCodec(),
    "bf16": BF16Codec(),
    "uint8": Uint8AffineCodec(),
    "int8_channel": Int8ChannelCodec(),
}


def get_codec(name: str) -> WireCodec:
    return CODECS[name]


def roundtrip(codec: WireCodec, x: torch.Tensor) -> torch.Tensor:
    """Quantise-dequantise (what the server-side half actually sees)."""
    return codec.decode(codec.encode(x), dtype=x.dtype)


def stack_payloads(payloads) -> Payload:
    """Stack single-request payload dicts into one micro-batch payload.

    The result has a new leading batch axis on every tensor (data AND
    quantisation headers) and round-trips through
    :meth:`WireCodec.decode_batch`.
    """
    payloads = list(payloads)
    if not payloads:
        raise ValueError("cannot stack an empty payload list")
    return {k: torch.stack([p[k] for p in payloads]) for k in payloads[0]}


def unstack_payload(payload: Payload) -> list[Payload]:
    """Inverse of :func:`stack_payloads`."""
    n = next(iter(payload.values())).shape[0]
    return [{k: v[i] for k, v in payload.items()} for i in range(n)]


def frame_bytes_rgba(x_size: int) -> int:
    """Bytes of a full RGBA frame (the server-only pipeline's payload)."""
    return 4 * x_size * x_size


def feature_bytes(x_size: int, n_stride2: int, k: int) -> int:
    """Bytes of the K-channel feature map after n stride-2 layers (paper),
    by the PassPlan's ceil rule per stride-2 layer."""
    from repro_torch.core.passplan import out_spatial_chain  # lazy: order
    s = out_spatial_chain(x_size, (2,) * n_stride2)
    return k * s * s


__all__ = ["BF16Codec", "CODECS", "Int8ChannelCodec", "Payload",
           "Uint8AffineCodec", "WireCodec", "feature_bytes",
           "frame_bytes_rgba", "get_codec", "roundtrip", "stack_payloads",
           "unstack_payload"]
