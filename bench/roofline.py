"""The yardstick's arithmetic: the card's peaks and a MiniConv decision's
operations and bytes.

A frozen copy, so that a change to the program cannot move the bound it
is measured against.  Today the encoder's operations equal the port's
``PassPlan.flops_per_frame`` and the projection's ``HeadPlan.flops``
(``bench/tests/test_bench_roofline.py`` holds them equal).
"""
from __future__ import annotations

# Published peaks, dense, at the card's full power limit (NVIDIA H100 SXM
# data sheet): float32 outside the tensor cores, and HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(kind: str):
    """The peaks of the card named ``kind``, or None for an unknown card."""
    return PEAKS.get(kind)


def _out(x: int, stride: int) -> int:
    return -(-x // stride)


def encoder_flops(config: dict) -> int:
    """Operations of one frame through the encoder: each layer's own
    convolution, 2 per multiply-add, without a tile's halo recomputed."""
    h = w = config["manifest"]["h"]
    total = 0
    for l in config["encoder"]["layers"]:
        h, w = _out(h, l["stride"]), _out(w, l["stride"])
        total += 2 * h * w * l["kernel"] ** 2 * l["c_in"] * l["c_out"]
    return total


def feature_count(config: dict) -> int:
    """Values in one frame's feature map."""
    h = w = config["manifest"]["h"]
    for l in config["encoder"]["layers"]:
        h, w = _out(h, l["stride"]), _out(w, l["stride"])
    return h * w * config["encoder"]["layers"][-1]["c_out"]


def projection_flops(config: dict) -> int:
    """Operations of one decision's dense projection: 2 x in x out."""
    return 2 * feature_count(config) * config["manifest"]["head_dim"]


def encoder_bytes(config: dict, frames: int) -> int:
    """Bytes the encoder must move for ``frames`` frames at the least:
    the float32 frames read once, every weight and bias read once, the
    float32 features written once."""
    m = config["manifest"]
    weights = sum(l["kernel"] ** 2 * l["c_in"] * l["c_out"] + l["c_out"]
                  for l in config["encoder"]["layers"])
    return 4 * (frames * m["h"] * m["h"] * m["c_in"] + weights
                + frames * feature_count(config))


def encoder_bound_s(config: dict, frames: int, kind: str):
    """The least time the card could take to encode ``frames`` frames:
    the larger of operations over the float32 peak and bytes over the
    memory bandwidth; None for an unknown card."""
    p = peak(kind)
    if p is None:
        return None
    return max(frames * encoder_flops(config) / p["fp32_flops"],
               encoder_bytes(config, frames) / p["hbm_bytes"])


__all__ = ["PEAKS", "encoder_bound_s", "encoder_bytes", "encoder_flops",
           "feature_count", "peak", "projection_flops"]
