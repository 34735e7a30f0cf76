"""Process start to the first timed tick: interpreter and imports, the
CUDA context, the kernel libraries (built on a checkout's first run),
weights, frames and warm-up (host clock)."""

UNIT = "s"


def read(rec: dict):
    return rec["setup_s"]
