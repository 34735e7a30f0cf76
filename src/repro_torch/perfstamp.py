"""Execution-mode and host stamps for the port's perf artifacts (port of
``repro.perfstamp``).

``mode`` is ``"cuda"`` when the hand-written kernels ran on a GPU and
``"eager"`` for plain PyTorch; ``host`` names the device through
``torch.cuda.get_device_name``.  :func:`check_comparable` refuses to
compare entries across execution modes or sim-vs-real transports.
"""
from __future__ import annotations

import os
import platform
from typing import Optional

import torch


def execution_mode(device=None) -> str:
    """``"cuda"`` for a CUDA device (hand kernels), else ``"eager"``."""
    return "cuda" if torch.device(device or "cpu").type == "cuda" \
        else "eager"


def host_fingerprint() -> str:
    """``platform/machine/device-name/cpu-count``, e.g.
    ``linux/x86_64/NVIDIA H100 80GB HBM3/8``; ``cpu`` names the device
    when there is no CUDA."""
    device = (torch.cuda.get_device_name(0).replace("/", "-")
              if torch.cuda.is_available() else "cpu")
    return "/".join([platform.system().lower(), platform.machine(),
                     device, str(os.cpu_count() or 0)])


def stamp(entry: dict, *, backend: Optional[str] = None, device=None,
          transport: Optional[str] = None) -> dict:
    """Return a copy of ``entry`` stamped with mode/host (+ backend,
    + transport: ``"sim"`` or ``"socket"``)."""
    out = dict(entry)
    out["mode"] = execution_mode(device)
    out["host"] = host_fingerprint()
    if backend is not None:
        out["backend"] = backend
    if transport is not None:
        out["transport"] = transport
    return out


def mismatches(a: dict, b: dict) -> list[str]:
    """Comparability defects between two stamped entries.

    ``mode`` mismatches (or a missing ``mode`` on either side) and
    ``transport`` mismatches are hard failures for
    :func:`check_comparable`; ``host``/``backend`` mismatches are reported
    but still make a meaningful (cross-host) comparison.
    """
    out = []
    ma, mb = a.get("mode"), b.get("mode")
    if ma is None or mb is None:
        out.append(f"mode missing (got {ma!r} vs {mb!r}; artifact predates "
                   "stamping — re-run the benchmark)")
    elif ma != mb:
        out.append(f"mode {ma!r} != {mb!r}")
    ta, tb = a.get("transport"), b.get("transport")
    if (ta is None) != (tb is None):
        out.append(f"transport stamped on one side only ({ta!r} vs {tb!r}; "
                   "sim-vs-real comparisons are calibration, not diffs)")
    elif ta is not None and ta != tb:
        out.append(f"transport {ta!r} != {tb!r}")
    for key in ("host", "backend"):
        va, vb = a.get(key), b.get(key)
        if va is not None and vb is not None and va != vb:
            out.append(f"{key} {va!r} != {vb!r}")
    return out


def check_comparable(a: dict, b: dict, *, what: str = "artifacts") -> None:
    """Raise ValueError when two stamped entries must not be compared."""
    hard = [m for m in mismatches(a, b)
            if m.startswith(("mode", "transport"))]
    if hard:
        raise ValueError(
            f"refusing to compare {what} across execution modes: "
            + "; ".join(hard))


__all__ = ["check_comparable", "execution_mode", "host_fingerprint",
           "mismatches", "stamp"]
