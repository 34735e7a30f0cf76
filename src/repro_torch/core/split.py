"""Split-policy abstraction (port of ``repro.core.split``).

A :class:`SplitModel` partitions a (params, x) -> y function into an
*edge* half and a *server* half with a wire codec at the boundary:

    features      = edge_apply(edge_params, obs)          # on-device
    payload       = codec.encode(features)                # uint8 buffer
    --- network ---
    features'     = codec.decode(payload)
    action/logits = server_apply(server_params, features') # remote
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import tracing
from repro_torch.core.wire import WireCodec, get_codec
from repro_torch.device import DeviceLike

Params = Any


@dataclasses.dataclass(frozen=True)
class SplitModel:
    edge_apply: Callable[[Params, torch.Tensor], torch.Tensor]
    server_apply: Callable[[Params, torch.Tensor], Any]
    codec: WireCodec
    quantize_in_train: bool = False
    # For MiniConv edges: the compiled PassPlan the edge half executes.
    plan: Any = None

    # ---- deployment path ---------------------------------------------------
    def edge_step(self, edge_params, obs):
        """Runs on-device; returns the wire payload."""
        return self.codec.encode(self.edge_apply(edge_params, obs))

    def server_step(self, server_params, payload):
        return self.server_apply(server_params, self.codec.decode(payload))

    # ---- batched deployment path -------------------------------------------
    def edge_step_batch(self, edge_params, obs_batch):
        """Encode a stacked (B, ...) batch in ONE edge call, quantised per
        example (each payload is the single-frame path's)."""
        with tracing.span("split.edge"):
            feats = self.edge_apply(edge_params, obs_batch)
            with tracing.span("codec.encode"):
                return self.codec.encode_batch(feats)

    def server_step_batch(self, server_params, payload_batch):
        """Serve a stacked micro-batch payload (see ``wire.stack_payloads``)
        with one decode + one server_apply over the leading batch axis."""
        with tracing.span("split.server"):
            with tracing.span("codec.decode"):
                feats = self.codec.decode_batch(payload_batch)
            with tracing.span("server.apply"):
                return self.server_apply(server_params, feats)

    def wire_bytes(self, feature_shape: Optional[tuple] = None, *,
                   batch: int = 1) -> int:
        if feature_shape is None:
            if self.plan is None:
                raise ValueError("feature_shape required for plan-less split")
            feature_shape = self.plan.feature_shape
        return self.codec.wire_bytes_batch(feature_shape, batch)

    # ---- training path (single process, differentiable) --------------------
    def apply(self, params, obs):
        feats = self.edge_apply(params["edge"], obs)
        if self.quantize_in_train:
            feats = straight_through(self.codec, feats)
        return self.server_apply(params["server"], feats)


def straight_through(codec: WireCodec, x: torch.Tensor) -> torch.Tensor:
    """Quantise in the forward pass, identity gradient in the backward."""
    q = codec.decode(codec.encode(x), dtype=x.dtype)
    return x + (q - x).detach()


def make_split_policy(edge_apply, server_apply, *, codec: str = "uint8",
                      quantize_in_train: bool = False) -> SplitModel:
    return SplitModel(edge_apply=edge_apply, server_apply=server_apply,
                      codec=get_codec(codec),
                      quantize_in_train=quantize_in_train)


def make_miniconv_split(spec, server_apply, *, h: int,
                        w: Optional[int] = None, codec: str = "uint8",
                        use_kernel="fused", quantize_in_train: bool = False,
                        device: DeviceLike = None) -> SplitModel:
    """Split policy whose edge half is a MiniConv encoder compiled to a
    :class:`~repro_torch.core.passplan.PassPlan`, on ``device``.

    .. deprecated::
        Thin shim over :meth:`repro_torch.deploy.Deployment.build`, the
        one canonical pipeline constructor.  The built deployment's split
        is returned with ``server_apply`` substituted, so custom server
        halves keep working; new code should construct a
        :class:`repro_torch.deploy.DeploymentConfig` and use
        ``Deployment.build(cfg).split`` directly.
    """
    from repro_torch.deploy import Deployment, DeploymentConfig  # layering

    cfg = DeploymentConfig(spec=spec, in_h=h, in_w=h if w is None else w,
                           backend=use_kernel, codec=codec,
                           quantize_in_train=quantize_in_train)
    dep = Deployment.build(cfg, device=device)
    return dataclasses.replace(dep.split, server_apply=server_apply)


__all__ = ["SplitModel", "make_miniconv_split", "make_split_policy",
           "straight_through"]
