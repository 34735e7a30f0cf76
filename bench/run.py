"""The benchmark's command:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  It puts the checkout's ``src`` and root
on the path (the program is ``src/repro_torch``; the harness is the
``bench`` package) and hands over to ``bench.harness``.  The set-up time
counts from the process's start, read from ``/proc`` before anything is
imported.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (10 ms steps); 0 where
    ``/proc`` cannot be read."""
    try:
        hz = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / hz
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age()
ROOT = Path(__file__).resolve().parents[1]
# the script's own directory would make bench's modules importable under
# a second, top-level name: put the checkout's src and root there instead
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

if __name__ == "__main__":
    from bench import harness
    sys.exit(harness.main(t0=T0, age0=AGE0))
