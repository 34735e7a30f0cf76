"""The split MiniConv encoder, the Full-CNN baseline and the deterministic
policy/value heads (port of the serving part of ``repro.rl.networks``).

* ``full_cnn`` — the SB3 NatureCNN feature extractor, the paper's
  server-only baseline: VALID convs 8x8/4 x32, 4x4/2 x64, 3x3/1 x64,
  flatten, dense 512 + ReLU.  Kernels are HWIO and dense weights
  ``(in, out)``, so ``convert.params_from_jax`` carries the reference's
  tree unchanged.  The reference runs these convs outside any Pallas
  kernel, so here they are ``F.conv2d`` through ``nn.layers.conv2d``.
* ``miniconv`` — the paper's on-device encoder; the conv stack is the
  *edge* half, the flatten + dense(512) belongs to the *server* half, so
  the wire tensor is exactly the K-channel feature map the paper sends.
* Heads: Gaussian actor (mean and log-std), squashed-Gaussian actor
  (its mode, and its sampler with the standard-normal draw as an
  argument), deterministic actor, Q and V critics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.miniconv import (MiniConvSpec, miniconv_apply,
                                       miniconv_init)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.layers import conv2d, conv2d_init, dense, dense_init
from repro_torch.nn.module import orthogonal_init

FEATURE_DIM = 512


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

def full_cnn_init(gen: torch.Generator, c_in: int, *, h: int = 84,
                  w: int = 84, device: DeviceLike = None):
    dev = resolve_device(device)
    # NatureCNN spatial sizes for 84x84 (VALID padding as in SB3/torch)
    h1, w1 = (h - 8) // 4 + 1, (w - 8) // 4 + 1       # 20
    h2, w2 = (h1 - 4) // 2 + 1, (w1 - 4) // 2 + 1     # 9
    h3, w3 = h2 - 3 + 1, w2 - 3 + 1                   # 7
    if h3 < 1 or w3 < 1:
        raise ValueError(f"full_cnn needs an input of at least 36x36, got "
                         f"{h}x{w}")
    flat = h3 * w3 * 64
    return {
        "conv1": conv2d_init(gen, 8, 8, c_in, 32, device=dev),
        "conv2": conv2d_init(gen, 4, 4, 32, 64, device=dev),
        "conv3": conv2d_init(gen, 3, 3, 64, 64, device=dev),
        "proj": dense_init(gen, flat, FEATURE_DIM, use_bias=True,
                           device=dev),
    }


def full_cnn_apply(params, obs):
    """obs: (B, H, W, C) in [0,1] -> (B, 512)."""
    x = torch.relu(conv2d(params["conv1"], obs, stride=4, padding="VALID"))
    x = torch.relu(conv2d(params["conv2"], x, stride=2, padding="VALID"))
    x = torch.relu(conv2d(params["conv3"], x, stride=1, padding="VALID"))
    x = x.reshape(x.shape[0], -1)
    return torch.relu(dense(params["proj"], x))


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
    init: Any                       # (gen) -> params on the device
    apply: Any                      # (params, obs) -> (B, 512)
    spec: MiniConvSpec | None = None

    def plan(self, h: int = 84, w: int = 84):
        """Compiled pass plan of the edge half."""
        return None if self.spec is None else self.spec.plan(h, w)


def make_encoder(name: str, c_in: int = 9, *, use_kernel=False,
                 fused_head: bool = False,
                 device: DeviceLike = None) -> Encoder:
    """name in {"full_cnn", "miniconv4", "miniconv16"}.

    For MiniConv encoders a thin shim over
    :meth:`repro_torch.deploy.Deployment.build`, the one pipeline
    constructor: ``use_kernel`` picks the execution backend and
    ``fused_head=True`` sets ``head_placement="fused"``.  ``full_cnn``
    (the paper's server-only baseline) has no split pipeline.
    """
    dev = resolve_device(device)
    if name == "full_cnn":
        return Encoder("full_cnn",
                       lambda gen: full_cnn_init(gen, c_in, device=dev),
                       full_cnn_apply)
    if name.startswith("miniconv"):
        from repro_torch.deploy import (Deployment,  # lazy: deploy imports
                                        DeploymentConfig)  # this module
        cfg = DeploymentConfig.from_encoder_name(
            name, c_in=c_in, backend=use_kernel,
            head_placement="fused" if fused_head else "server")
        return Deployment.build(cfg, device=dev).encoder
    raise ValueError(f"unknown encoder {name}")


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


def softplus(x):
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``, with no
    threshold (``F.softplus`` returns ``x`` above 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def squashed_actor_sample(params, feats, eps):
    """A tanh-squashed Gaussian action, its log-probability and the mode,
    from the standard-normal draw ``eps`` (shape of the action)."""
    out = mlp_apply(params["mlp"], feats)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, -10.0, 2.0)
    std = torch.exp(log_std)
    pre = mean + std * eps
    action = torch.tanh(pre)
    # log prob with tanh correction
    logp = (-0.5 * (eps * eps + 2 * log_std
                    + math.log(2 * math.pi))).sum(-1)
    logp = logp - torch.sum(2 * (math.log(2.0) - pre - softplus(-2 * pre)),
                            -1)
    return action, logp, torch.tanh(mean)


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
           "full_cnn_apply", "full_cnn_init", "gaussian_actor",
           "gaussian_actor_init", "make_encoder", "miniconv_edge_apply",
           "miniconv_encoder_init", "miniconv_server_apply", "mlp_apply",
           "mlp_init", "q_critic", "q_critic_init", "softplus",
           "squashed_actor_init",
           "squashed_actor_mode", "squashed_actor_sample", "v_critic",
           "v_critic_init"]
