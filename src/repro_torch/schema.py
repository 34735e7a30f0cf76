"""Shared schema-versioning helpers for serialised config dataclasses.

Every long-lived JSON schema in the repo (`DeploymentConfig`, `Scenario`,
`TunedPlan`, `ShapingConfig`) writes a ``version`` field and refuses
versions it cannot read via :func:`check_version`, raising the typed
:class:`SchemaVersionError` — a ``ValueError`` subclass so existing
``pytest.raises(ValueError, match="version")`` callers keep working —
instead of silently dropping unknown fields.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["SchemaVersionError", "check_version"]


class SchemaVersionError(ValueError):
    """A serialised schema names a version this build cannot read."""


def check_version(kind: str, version, readable: Sequence[int]) -> int:
    """Validate a loaded dict's schema version; return it on success."""
    if version not in tuple(readable):
        raise SchemaVersionError(
            f"{kind} schema version {version!r} is not readable by this "
            f"build (readable: {', '.join(str(v) for v in readable)}); "
            "refusing to load rather than silently dropping fields"
        )
    return version
