"""Host time a tick spends dispatching: from the tick's start until its
last operation is enqueued (host clock, over the traced run's untraced
stretch, the wait for the device left out), over the stretch's ticks."""

UNIT = "ms"


def read(rec: dict):
    if "host_dispatch_s" not in rec or not rec["ticks"]:
        return None
    return rec["host_dispatch_s"] / rec["ticks"] * 1e3
