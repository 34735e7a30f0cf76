"""The whole decision's share of the card's float32 peak: the encoder's
and the projection's operations a decision, times the decisions of the
traced run's untraced stretch, over its seconds, over the peak
(``roofline.PEAKS``; the configurations compute in float32)."""
from bench import roofline

UNIT = "%"


def read(rec: dict):
    p = roofline.peak(rec["device_kind"])
    if p is None:
        return None
    cfg = rec["config"]
    flops = roofline.encoder_flops(cfg) + roofline.projection_flops(cfg)
    return flops * rec["units"] / rec["window_s"] / p["fp32_flops"] * 100
