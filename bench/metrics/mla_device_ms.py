"""Device time a tick of the operations launched inside the program's
``mla`` spans (every multi-head latent attention mixer: its projections,
the latent's norm, RoPE and the query and key assembly, the K5 core and
``o_proj``), from the traced ticks reduced over the program's spans
(``closed_ticks_mla``)."""

UNIT = "ms"


def read(rec: dict):
    return ((rec.get("spans") or {}).get("device_ms") or {}).get("mla")
