"""Share of the traced window in which no operation ran on the device:
one less the union of the device operations' intervals (not their sum)
over the window, from the profiler's trace."""

UNIT = "%"


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["ops"] or not t["window_us"]:
        return None
    return (1 - t["busy_us"] / t["window_us"]) * 100
