"""The port's device rule: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without CUDA raises; there
    is no quiet fall-back to the CPU — pass ``device="cpu"`` for that.
    ``"meta"`` makes allocation-free stand-ins (shapes and dtypes only),
    as the dry-run's abstract inputs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the port runs on the GPU "
            "by default — pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or "
                         f"'meta'")
    return dev


__all__ = ["DeviceLike", "resolve_device"]
