"""Findings baseline: `--strict` gates NEW findings, not the backlog.

The port's baseline file (``src/repro_torch/analysis/baseline.json``, in
the reference's format: ``repro.analysis`` keeps ``analysis_baseline.json``
at the repo root) records the fingerprints of known findings plus every
live suppression comment.
Fingerprints are content-based (rule + path + hash of the stripped source
line + occurrence index), so unrelated line-number drift does not
invalidate entries; editing the flagged line does, which is the point —
touched code must come clean.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import Finding, Suppression

BASELINE_VERSION = 1

__all__ = [
    "BASELINE_VERSION",
    "load_baseline",
    "save_baseline",
    "diff_against_baseline",
    "baseline_problems",
]


def load_baseline(path: Path) -> dict:
    if not path.exists():
        return {"version": BASELINE_VERSION, "findings": [], "suppressions": []}
    data = json.loads(path.read_text())
    version = data.get("version")
    if version != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {version!r}; this tool reads "
            f"version {BASELINE_VERSION} — regenerate with --write-baseline"
        )
    return data


def save_baseline(
    path: Path, findings: Sequence[Finding], suppressions: Sequence[Suppression]
) -> None:
    data = {
        "version": BASELINE_VERSION,
        "findings": [
            dict(fingerprint=f.fingerprint, **f.to_dict())
            for f in findings
            if not f.suppressed
        ],
        "suppressions": [
            {
                "path": s.path,
                "line": s.line,
                "rules": list(s.rules),
                "justification": s.justification,
            }
            for s in suppressions
        ],
    }
    path.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")


def diff_against_baseline(
    findings: Sequence[Finding], baseline: dict
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split live unsuppressed findings into (new, known); also return the
    stale baseline fingerprints that no longer fire (candidates for a
    baseline regeneration)."""
    known_fps = {f["fingerprint"] for f in baseline.get("findings", [])}
    live = [f for f in findings if not f.suppressed]
    new = [f for f in live if f.fingerprint not in known_fps]
    known = [f for f in live if f.fingerprint in known_fps]
    live_fps = {f.fingerprint for f in live}
    stale = sorted(known_fps - live_fps)
    return new, known, stale


def baseline_problems(baseline: dict) -> List[str]:
    """CI gate: a baseline may not carry unjustified suppressions."""
    problems = []
    for s in baseline.get("suppressions", []):
        if not str(s.get("justification", "")).strip():
            problems.append(
                f"{s.get('path')}:{s.get('line')} baseline suppression for "
                f"{s.get('rules')} has no justification string"
            )
    return problems
