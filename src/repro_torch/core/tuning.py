"""The frozen tuning block of a deployment manifest (port of the data part
of ``repro.core.tuning``).

:class:`TunedPlan` is kept as data so that version-2 manifests carrying a
``tuning`` block load in the port.  ``mode``/``host`` say where the block
was measured; ``repro_torch.deploy.Deployment.build`` honours a block only
when its ``mode`` is one of the port's (:data:`PORT_MODES`).  The tuner
itself is not ported yet.
"""
from __future__ import annotations

import dataclasses

from repro_torch.schema import check_version

TUNING_VERSION = 1

# Execution modes the port stamps (``repro_torch.perfstamp``); the
# reference stamps "interpret" / "compiled".
PORT_MODES = ("eager", "cuda")


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The measured winner, frozen into the deployment manifest.

    ``time_s`` is the median launch time at ``micro_batch`` frames;
    ``per_frame_s`` the serving cost per frame at the manifest's
    ``max_batch``.  ``mode``/``host`` record WHERE the measurement holds.
    All fields are scalars, keeping the config hashable.
    """

    backend: str
    tile_h: int
    micro_batch: int
    time_s: float = 0.0
    per_frame_s: float = 0.0
    mode: str = "interpret"
    host: str = ""
    searched: int = 0        # candidates actually measured
    pruned: int = 0          # candidates cut by the cost model
    version: int = TUNING_VERSION

    @property
    def measured_by_port(self) -> bool:
        return self.mode in PORT_MODES

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedPlan":
        d = dict(d)
        version = check_version("TunedPlan tuning block",
                                d.pop("version", TUNING_VERSION),
                                (TUNING_VERSION,))
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown TunedPlan fields: {sorted(unknown)}")
        return cls(version=version, **d)


__all__ = ["PORT_MODES", "TUNING_VERSION", "TunedPlan"]
