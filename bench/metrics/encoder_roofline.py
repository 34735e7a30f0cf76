"""The MiniConv encoder kernel's share of its roofline: the least time the
card could take for a tick's frames (``roofline.encoder_bound_s``: the
larger of the encoder's operations over the float32 peak and its bytes
over the memory bandwidth) over the device time a tick of the kernels
named ``encoder_kernel`` (K1) and ``encoder_stream_kernel`` (K4)."""
import re

from bench import roofline

UNIT = "%"
KERNELS = re.compile(r"\bencoder(_stream)?_kernel\b")


def read(rec: dict):
    t = rec.get("trace")
    ops = [d for name, _, d, _ in (t or {}).get("ops", ())
           if KERNELS.search(name)]
    if not ops or "units_per_tick" not in rec:
        return None
    bound = roofline.encoder_bound_s(rec["config"], rec["units_per_tick"],
                                     rec["device_kind"])
    if bound is None:
        return None
    return bound / (sum(ops) / t["ticks"] / 1e6) * 100
