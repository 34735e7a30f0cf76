"""The port's hand-written CUDA kernels, their wrappers and plain versions.

``miniconv_pass``, ``flash_attention``, ``moe_grouped`` and ``ssd_scan``
hold the wrappers, ``ref`` the plain PyTorch versions, ``ops`` the
per-pass layer and causal attention, ``_build`` the nvcc build and ctypes
loading, and ``csrc/`` the CUDA sources.
"""
from repro_torch.kernels._build import cuda_kernels_supported

__all__ = ["cuda_kernels_supported"]
