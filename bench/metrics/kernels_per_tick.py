"""Device operations (kernels, copies, sets) in the traced window over
its ticks, from the profiler's trace."""

UNIT = "kernels"


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["ops"]:
        return None
    return len(t["ops"]) / t["ticks"]
