"""K5's share of its roofline on the MLA cores: the least time the card
could take for a tick's causal cores (``mla_roofline.core_bound_s``: the
larger of 2 H (192 + 128) operations a (query, key) pair over the bf16
peak and q, k, v and o moved once over the memory bandwidth) over the
device time a tick of the kernels named ``flash_kernel`` (both of K5's
routes)."""
import re

from bench import mla_roofline

UNIT = "%"
KERNELS = re.compile(r"\bflash_kernel")


def read(rec: dict):
    t = rec.get("trace")
    ops = [d for name, _, d, _ in (t or {}).get("ops", ())
           if KERNELS.search(name)]
    params = (rec.get("cell") or {}).get("params") or {}
    if not ops or "seq_len" not in params:
        return None
    bound = mla_roofline.core_bound_s(rec["config"], params["seq_len"],
                                      rec["units_per_tick"],
                                      rec["device_kind"])
    if bound is None:
        return None
    return bound / (sum(ops) / t["ticks"] / 1e6) * 100
