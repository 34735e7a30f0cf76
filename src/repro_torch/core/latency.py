"""Closed-loop decision-latency model (paper §4.2) and its generalisation
(port of ``repro.core.latency``).

Paper's simplified model: link bandwidth B (bits/s), square input of side X,
n stride-2 encoder layers, per-frame on-device encode time j, K transmitted
channels; both pipelines send uncompressed uint8 buffers:

  server-only payload : 4 X^2 bytes (RGBA frame)
  split payload       : K (X/2^n)^2 bytes

Split inference wins iff  B < 32 X^2 (1 - K / (4 * 2^(2n))) / j.

``decision_latency_*`` add the measurable constant terms (server compute,
action return, fixed network RTT) used by the end-to-end simulators in
``repro_torch.serving``.  Plain float arithmetic: equal inputs give the
reference's numbers exactly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkModel:
    bandwidth_bps: float            # shaped link bandwidth, bits/s
    rtt_s: float = 0.004            # propagation round trip (both pipelines)

    def tx_time(self, payload_bytes: float) -> float:
        return 8.0 * payload_bytes / self.bandwidth_bps


@dataclasses.dataclass(frozen=True)
class SplitConfig:
    x_size: int                     # input side X
    n_stride2: int                  # n
    k_channels: int                 # K
    encode_time_s: float            # j

    @property
    def frame_bytes(self) -> int:
        return 4 * self.x_size ** 2

    @property
    def feature_bytes(self) -> int:
        # PassPlan spatial rule: ceil per stride-2 layer (matches the real
        # feature shape; the continuous X/2^n model below is the paper's
        # closed-form approximation of this).
        from repro_torch.core.passplan import out_spatial_chain
        return self.k_channels * out_spatial_chain(
            self.x_size, (2,) * self.n_stride2) ** 2


def break_even_bandwidth(cfg: SplitConfig) -> float:
    """Bits/s below which the split pipeline has lower decision latency.

    Derivation (paper): latency_server_only = 32 X^2 / B;
    latency_split = j + 8 K (X/2^n)^2 / B.  Setting them equal:
      B* = (32 X^2 - 8 K X^2 / 2^(2n)) / j = 32 X^2 (1 - K/(4*2^(2n))) / j.
    """
    x, n, k, j = (cfg.x_size, cfg.n_stride2, cfg.k_channels,
                  cfg.encode_time_s)
    return 32.0 * x * x * (1.0 - k / (4.0 * 2.0 ** (2 * n))) / j


def decision_latency_server_only(cfg: SplitConfig, link: LinkModel, *,
                                 server_time_s: float = 0.0,
                                 action_bytes: int = 64) -> float:
    return (link.tx_time(cfg.frame_bytes) + server_time_s
            + link.tx_time(action_bytes) + link.rtt_s)


def decision_latency_split(cfg: SplitConfig, link: LinkModel, *,
                           server_time_s: float = 0.0,
                           action_bytes: int = 64) -> float:
    return (cfg.encode_time_s + link.tx_time(cfg.feature_bytes)
            + server_time_s + link.tx_time(action_bytes) + link.rtt_s)


def paper_pi_zero_config() -> SplitConfig:
    """Figure 3b's configuration: X=400, n=3, j~=0.1s, K=4 => B* ~= 50.4 Mb/s."""
    return SplitConfig(x_size=400, n_stride2=3, k_channels=4,
                       encode_time_s=0.1)


# ---------------------------------------------------------------------------
# Generalisation to the pod-boundary transformer split
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PodSplitConfig:
    """Split a transformer at a layer boundary across the inter-pod link."""

    hidden_bytes_full: int          # boundary activation bytes, fp32
    wire_itemsize: float            # codec bytes/elem (1.0 for int8)
    edge_time_s: float              # time to run the edge-side stage
    raw_bytes: int                  # what would cross without the split
                                    # (e.g. full input or fp32 activation)

    @property
    def wire_bytes(self) -> float:
        return self.hidden_bytes_full * self.wire_itemsize / 4.0


def pod_break_even_bandwidth(cfg: PodSplitConfig) -> float:
    saved_bytes = cfg.raw_bytes - cfg.wire_bytes
    if saved_bytes <= 0:
        return 0.0
    return 8.0 * saved_bytes / cfg.edge_time_s


__all__ = ["LinkModel", "PodSplitConfig", "SplitConfig",
           "break_even_bandwidth", "decision_latency_server_only",
           "decision_latency_split", "paper_pi_zero_config",
           "pod_break_even_bandwidth"]
