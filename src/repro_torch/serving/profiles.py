"""Named device profiles: the heterogeneous hardware zoo (port of
``repro.serving.profiles``).

The paper measures the split policy on three fixed edge devices — Jetson
Nano, Raspberry Pi 4B, Pi Zero 2W — each with its own batched service
curve t(B) and on-device encode time.  The scenario engine serves a
POPULATION of such devices: a :class:`DeviceProfile` names one hardware
class (its t(B) curve as
:class:`~repro_torch.serving.server.BatchServiceModel` points plus its
per-frame encode cost), ``DEVICE_PROFILES`` registers
them, and :func:`zoo` cycles named profiles across a fleet's servers so
``FleetQueueSim.service_models`` sees a heterogeneous fleet.

The four registered curves are the reference's paper-shaped model
inputs for edge devices, copied unchanged: they are not measurements of
the GPU this port runs on, nor of any host.  The Pi Zero 2W encode time
matches the paper's ~0.1 s MiniConv frame time at X=400 (see
``repro_torch.core.latency.paper_pi_zero_config``), the others scale by
the devices' relative compute, and every t(B) curve keeps the paper's
qualitative shape — near-flat batching gain on the GPU-backed Jetson,
near-linear growth on the CPU-bound Pis.  Measure a real server with
``BatchingPolicyServer.measure`` and :func:`register_profile` it to pin
real hardware.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.server import BatchServiceModel


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One hardware class: batched service curve + on-device encode cost.

    ``service_points`` is the t(B) curve ((batch, seconds), ...) this
    device sustains when serving the remote half; ``encode_s`` is its
    per-frame on-device encoder time (what a client of this class pays
    before its payload hits the uplink).
    """
    name: str
    service_points: tuple
    encode_s: float
    notes: str = ""

    def __post_init__(self):
        object.__setattr__(self, "service_points",
                           tuple((int(b), float(t))
                                 for b, t in self.service_points))
        # constructor-validate the curve once, eagerly
        BatchServiceModel(self.service_points)
        if self.encode_s < 0.0:
            raise ValueError(f"encode_s must be >= 0: {self.encode_s}")

    def service_model(self, *, out_of_range: str = "extrapolate") \
            -> BatchServiceModel:
        return BatchServiceModel(self.service_points,
                                 out_of_range=out_of_range)


DEVICE_PROFILES: dict[str, DeviceProfile] = {}


def register_profile(profile: DeviceProfile) -> DeviceProfile:
    DEVICE_PROFILES[profile.name] = profile
    return profile


def get_profile(name: str) -> DeviceProfile:
    try:
        return DEVICE_PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown device profile {name!r}; registered: "
                       f"{sorted(DEVICE_PROFILES)}") from None


def profile_names() -> tuple[str, ...]:
    return tuple(DEVICE_PROFILES)


def zoo(names, n_servers: int, *,
        out_of_range: str = "extrapolate") -> tuple:
    """Cycle named profiles across ``n_servers`` service models — the
    ``FleetQueueSim.service_models`` tuple for a heterogeneous fleet."""
    names = tuple(names)
    if not names:
        raise ValueError("zoo needs at least one profile name")
    profiles = [get_profile(n) for n in names]
    return tuple(profiles[s % len(profiles)]
                 .service_model(out_of_range=out_of_range)
                 for s in range(n_servers))


register_profile(DeviceProfile(
    name="jetson_nano",
    service_points=((1, 0.0040), (2, 0.0048), (4, 0.0062), (8, 0.0090)),
    encode_s=0.008,
    notes="GPU-backed: batching amortises launch overhead, t(B) near-flat"))

register_profile(DeviceProfile(
    name="pi_4b",
    service_points=((1, 0.0120), (2, 0.0190), (4, 0.0330), (8, 0.0610)),
    encode_s=0.033,
    notes="quad A72: moderate batching gain, then near-linear"))

register_profile(DeviceProfile(
    name="pi_zero_2w",
    service_points=((1, 0.0450), (2, 0.0850), (4, 0.1650), (8, 0.3250)),
    encode_s=0.100,
    notes="paper's ~0.1 s MiniConv frame time at X=400; t(B) near-linear"))

register_profile(DeviceProfile(
    name="workstation",
    service_points=((1, 0.0020), (2, 0.0022), (4, 0.0026), (8, 0.0034)),
    encode_s=0.002,
    notes="synthetic fast host: the near-ideal batching end of the zoo"))


__all__ = ["DeviceProfile", "DEVICE_PROFILES", "register_profile",
           "get_profile", "profile_names", "zoo"]
