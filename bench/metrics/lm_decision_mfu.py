"""The whole decision's share of the card's bf16 peak: a prefill
decision's operations (``lm_roofline.decision_flops``) times the decisions
of the traced run's untraced stretch, over its seconds, over the peak."""
from bench import lm_roofline

UNIT = "%"


def read(rec: dict):
    p = lm_roofline.peak(rec["device_kind"])
    params = (rec.get("cell") or {}).get("params") or {}
    if p is None or "seq_len" not in params:
        return None
    flops = lm_roofline.decision_flops(rec["config"], params["seq_len"])
    return flops * rec["units"] / rec["window_s"] / p["bf16_flops"] * 100
