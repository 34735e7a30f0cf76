"""95th percentile, over every tick of the window, of a tick's start
(frames ready) to its outputs on the host (host clock).  Every decision of
a tick has its tick's latency."""
import numpy as np

UNIT = "ms"


def read(rec: dict):
    return float(np.percentile(np.asarray(rec["lat_s"]), 95)) * 1e3
