"""Device time a tick of the operations launched inside the program's
``moe`` spans (every MoE layer: routing, the sort, K7, the combine and the
shared expert), from the traced ticks reduced over the program's spans
(``closed_ticks_spans``)."""

UNIT = "ms"


def read(rec: dict):
    return ((rec.get("spans") or {}).get("device_ms") or {}).get("moe")
