"""Software rasteriser over a batch of frames: distance-field drawing onto
pixel grids (port of ``repro.envs.rendering``).

Every draw takes ``(N, h, w, 3)`` images and per-env geometry (``(N,)``
tensors or Python floats) and paints with ``torch.where``.  World
coordinates map through a :class:`Camera` with one centre per env, so the
tracking cameras (walker, hopper) and the static one (pendulum) share one
code path.  A camera grid can be a window of the full frame (the crop the
pixel wrapper takes): its coordinates are the full grid's at those pixels,
so drawing the window equals cropping the drawn frame bit for bit.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


@lru_cache(maxsize=None)
def _linspace(lo: float, hi: float, n: int, device: torch.device
              ) -> torch.Tensor:
    """``jnp.linspace(lo, hi, n)`` in float32: ``lo * (1 - s) + hi * s``
    with ``s = iota / (n - 1)``, and ``hi`` last."""
    s = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
    out = torch.cat([lo * (1 - s) + hi * s,
                     torch.tensor([hi], dtype=torch.float32)])
    return out.to(device)


@lru_cache(maxsize=None)
def _color(rgb: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(rgb, dtype=torch.float32).to(device)


def _col(v: Scalar) -> Scalar:
    """A per-env ``(N,)`` value as ``(N, 1, 1)`` against ``(N, h, w)``."""
    return v[:, None, None] if isinstance(v, torch.Tensor) else v


@dataclasses.dataclass(frozen=True)
class Camera:
    center_x: Scalar              # float or (N,)
    center_y: Scalar
    half_extent: float
    resolution: int = 100

    def grid(self, n: int, device: torch.device,
             window: Optional[tuple] = None):
        """(X, Y), each ``(N, h, w)``; row 0 is the top.  ``window`` is
        ``(oy, ox, size)``: ``(N,)`` integer offsets of a ``size``-square
        crop of the full ``resolution`` grid."""
        r = self.resolution
        ys = _linspace(1.0, -1.0, r, device)
        xs = _linspace(-1.0, 1.0, r, device)
        if window is None:
            ys, xs = ys.expand(n, r), xs.expand(n, r)
        else:
            oy, ox, size = window
            span = torch.arange(size, device=device)
            ys = ys[oy[:, None] + span]
            xs = xs[ox[:, None] + span]
        ys = ys * self.half_extent + _col1(self.center_y)
        xs = xs * self.half_extent + _col1(self.center_x)
        h, w = ys.shape[1], xs.shape[1]
        return xs[:, None, :].expand(n, h, w), ys[:, :, None].expand(n, h, w)


def _col1(v: Scalar) -> Scalar:
    return v[:, None] if isinstance(v, torch.Tensor) else v


def blank(n: int, h: int, w: int, device: torch.device,
          color=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """A broadcast view of ``color``: the first draw writes a new image."""
    return _color(tuple(color), device).expand(n, h, w, 3)


def _paint(img, mask, color):
    return torch.where(mask[..., None], _color(tuple(color), img.device), img)


def draw_circle(img, grid, cx, cy, radius, color):
    X, Y = grid
    dx, dy = X - _col(cx), Y - _col(cy)
    return _paint(img, dx * dx + dy * dy <= radius ** 2, color)


def draw_capsule(img, grid, x1, y1, x2, y2, radius, color):
    """Filled segment with round caps (how MuJoCo draws geoms)."""
    X, Y = grid
    dx, dy = x2 - x1, y2 - y1
    len2 = dx * dx + dy * dy + 1e-12
    t = torch.clamp(((X - _col(x1)) * _col(dx) + (Y - _col(y1)) * _col(dy))
                    / _col(len2), 0.0, 1.0)
    px = _col(x1) + t * _col(dx)
    py = _col(y1) + t * _col(dy)
    ex, ey = X - px, Y - py
    return _paint(img, ex * ex + ey * ey <= radius ** 2, color)


def draw_ground(img, grid, ground_y, color=(0.55, 0.45, 0.35)):
    _, Y = grid
    return _paint(img, Y <= ground_y, color)


def draw_checker_ground(img, grid, ground_y, period: float = 0.5):
    """Checkered ground so forward motion is visible to a tracking camera."""
    X, Y = grid
    stripe = torch.remainder(torch.floor(X / period).to(torch.int32), 2)
    ground = torch.where((stripe == 0)[..., None],
                         _color((0.60, 0.50, 0.40), img.device),
                         _color((0.45, 0.37, 0.30), img.device))
    return torch.where((Y <= ground_y)[..., None], ground, img)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)


__all__ = ["Camera", "blank", "draw_capsule", "draw_checker_ground",
           "draw_circle", "draw_ground", "to_uint8"]
