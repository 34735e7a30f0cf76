"""The split MiniConv encoder and the deterministic policy/value heads
(port of the serving part of ``repro.rl.networks``).

* ``miniconv`` — the paper's on-device encoder; the conv stack is the
  *edge* half, the flatten + dense(512) belongs to the *server* half, so
  the wire tensor is exactly the K-channel feature map the paper sends.
* Heads: Gaussian actor (mean and log-std), squashed-Gaussian actor mode,
  deterministic actor, Q and V critics.  The samplers come with training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.miniconv import (MiniConvSpec, miniconv_apply,
                                       miniconv_init)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import dense, dense_init
from repro_torch.nn.module import orthogonal_init

FEATURE_DIM = 512


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def miniconv_encoder_init(gen: torch.Generator, spec: MiniConvSpec, *,
                          h: int = 84, w: int = 84,
                          feature_dim: int = FEATURE_DIM,
                          device: DeviceLike = None):
    """Edge (conv passes) + server (projection) halves, kept separate so
    the deployment split is a dict split.  The projection width comes from
    the compiled PassPlan."""
    dev = resolve_device(device)
    fh, fw, k = spec.plan(h, w).feature_shape
    return {
        "edge": miniconv_init(gen, spec, device=dev),
        "server": {"proj": dense_init(gen, fh * fw * k, feature_dim,
                                      use_bias=True, device=dev)},
    }


def miniconv_edge_apply(params, spec: MiniConvSpec, obs, *,
                        use_kernel=False):
    """On-device half.  ``use_kernel`` selects the execution tier
    (``core.backends``): False (eager PyTorch, training), "reference" or
    "fused" (one CUDA kernel for the whole pass plan)."""
    return miniconv_apply(params, spec, obs, use_kernel=use_kernel)


def miniconv_server_apply(params, feats):
    x = feats.reshape(feats.shape[0], -1)
    return torch.relu(dense(params["proj"], x))


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Uniform encoder interface for the RL algorithms."""

    name: str
    init: Any
    apply: Any                      # (params, obs) -> (B, 512)
    spec: MiniConvSpec | None = None

    def plan(self, h: int = 84, w: int = 84):
        """Compiled pass plan of the edge half."""
        return None if self.spec is None else self.spec.plan(h, w)


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, sizes: list[int], *, use_bias=True,
             final_scale=0.01, device: DeviceLike = None):
    dev = resolve_device(device)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = final_scale if i == len(sizes) - 2 else math.sqrt(2.0)
        params[f"fc{i}"] = dense_init(gen, a, b, use_bias=use_bias,
                                      init=orthogonal_init(scale),
                                      device=dev)
    return params


def mlp_apply(params, x, *, final_act=None):
    n = len(params)
    for i in range(n):
        x = dense(params[f"fc{i}"], x)
        if i < n - 1:
            x = torch.relu(x)
    return final_act(x) if final_act is not None else x


def gaussian_actor_init(gen, feat_dim: int, action_dim: int, *,
                        device: DeviceLike = None):
    dev = resolve_device(device)
    return {"mlp": mlp_init(gen, [feat_dim, 256, action_dim], device=dev),
            "log_std": torch.zeros((action_dim,), device=dev)}


def gaussian_actor(params, feats):
    mean = mlp_apply(params["mlp"], feats)
    log_std = torch.clamp(params["log_std"], -5.0, 2.0)
    return mean, log_std.expand(mean.shape)


def squashed_actor_init(gen, feat_dim: int, action_dim: int, *,
                        device: DeviceLike = None):
    return {"mlp": mlp_init(gen, [feat_dim, 256, 2 * action_dim],
                            final_scale=0.01, device=device)}


def squashed_actor_mode(params, feats):
    """Deterministic action — tanh of the pre-squash mean: the policy a
    deployment serves."""
    mean, _ = torch.chunk(mlp_apply(params["mlp"], feats), 2, dim=-1)
    return torch.tanh(mean)


def q_critic_init(gen, feat_dim: int, action_dim: int, *,
                  device: DeviceLike = None):
    return {"mlp": mlp_init(gen, [feat_dim + action_dim, 256, 1],
                            final_scale=1.0, device=device)}


def q_critic(params, feats, action):
    return mlp_apply(params["mlp"], torch.cat([feats, action], -1))[..., 0]


def v_critic_init(gen, feat_dim: int, *, device: DeviceLike = None):
    return {"mlp": mlp_init(gen, [feat_dim, 256, 1], final_scale=1.0,
                            device=device)}


def v_critic(params, feats):
    return mlp_apply(params["mlp"], feats)[..., 0]


def det_actor_init(gen, feat_dim: int, action_dim: int, *,
                   device: DeviceLike = None):
    return {"mlp": mlp_init(gen, [feat_dim, 256, action_dim],
                            final_scale=0.01, device=device)}


def det_actor(params, feats):
    return torch.tanh(mlp_apply(params["mlp"], feats))


__all__ = ["Encoder", "FEATURE_DIM", "det_actor", "det_actor_init",
           "gaussian_actor", "gaussian_actor_init", "miniconv_edge_apply",
           "miniconv_encoder_init", "miniconv_server_apply", "mlp_apply",
           "mlp_init", "q_critic", "q_critic_init", "squashed_actor_init",
           "squashed_actor_mode", "v_critic", "v_critic_init"]
