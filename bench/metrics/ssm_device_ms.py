"""Device time a tick of the operations launched inside the program's
``ssm`` spans (every Mamba-2 mixer: projections, conv, the SSD scan, the
gated norm), from the traced ticks reduced over the program's spans
(``closed_ticks_spans``)."""

UNIT = "ms"


def read(rec: dict):
    return ((rec.get("spans") or {}).get("device_ms") or {}).get("ssm")
