"""The visual control suite over a batch of envs (port of ``repro.envs``;
replaces MuJoCo/Gymnasium offline)."""

from repro_torch.envs.base import Env
from repro_torch.envs.hopper import ENV as HOPPER
from repro_torch.envs.pendulum import ENV as PENDULUM
from repro_torch.envs.walker import ENV as WALKER

REGISTRY: dict[str, Env] = {
    "pendulum": PENDULUM,
    "hopper": HOPPER,
    "walker": WALKER,
}

from repro_torch.envs.wrappers import PixelEnv, make_pixel_env  # noqa: E402

__all__ = ["Env", "REGISTRY", "PixelEnv", "make_pixel_env",
           "PENDULUM", "HOPPER", "WALKER"]
