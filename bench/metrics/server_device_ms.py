"""Device time a tick of the operations launched under the ``server``
span (decode, projection, activation), from the profiler's trace."""

UNIT = "ms"


def read(rec: dict):
    t = rec.get("trace")
    ops = [d for _, _, d, span in (t or {}).get("ops", ())
           if span == "server"]
    if not ops:
        return None
    return sum(ops) / t["ticks"] / 1e3
