"""K7's share of its roofline: the least time the card could take for a
tick's routed rows (``lm_roofline.expert_bound_s``: the larger of 6 D F
operations a routed row over the bf16 peak and the rows, weights and
output bytes over the memory bandwidth) over the device time a tick of
the kernels named ``moe_grouped_kernel`` (both of K7's GEMMs)."""
import re

from bench import lm_roofline

UNIT = "%"
KERNELS = re.compile(r"\bmoe_grouped_kernel\b")


def read(rec: dict):
    t = rec.get("trace")
    ops = [d for name, _, d, _ in (t or {}).get("ops", ())
           if KERNELS.search(name)]
    params = (rec.get("cell") or {}).get("params") or {}
    if not ops or "seq_len" not in params:
        return None
    tokens = rec["units_per_tick"] * params["seq_len"]
    bound = lm_roofline.expert_bound_s(rec["config"], tokens,
                                       rec["device_kind"])
    if bound is None:
        return None
    return bound / (sum(ops) / t["ticks"] / 1e6) * 100
