"""The whole MLA decision's share of the card's bf16 peak: a prefill
decision's operations (``mla_roofline.decision_flops``) times the
decisions of the traced run's untraced stretch, over its seconds, over the
peak."""
from bench import mla_roofline

UNIT = "%"


def read(rec: dict):
    p = mla_roofline.peak(rec["device_kind"])
    params = (rec.get("cell") or {}).get("params") or {}
    config = rec.get("config") or {}
    if p is None or "seq_len" not in params or "kv_lora_rank" not in config:
        return None
    flops = mla_roofline.decision_flops(config, params["seq_len"])
    return flops * rec["units"] / rec["window_s"] / p["bf16_flops"] * 100
