"""Decisions completed in the window over the window's seconds: all the
work over all the time (host clock)."""

UNIT = "decisions/s"


def read(rec: dict):
    return rec["units"] / rec["window_s"]
