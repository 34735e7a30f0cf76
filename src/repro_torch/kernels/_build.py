"""Build the port's CUDA kernels with nvcc, load them with ctypes and
launch them.

Each source in ``csrc/`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds): one entry,
``int <library>_launch(const long long* a)``, whose argument array
follows the source's ``enum Arg`` and ends in the device index and the
raw ``cudaStream_t``.  :func:`launch` is the one way a kernel reaches the
card.  Each library is compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch/`` at the root of the checkout, a directory git
ignores.  A library's file name carries a hash of its source and flags, so
an edited source is rebuilt and a stale one is never loaded.
:func:`build` starts one nvcc per missing source, all at once.

Nothing here runs at import: the module imports on a host with no nvcc
and no GPU, and only a kernel launch needs a library.
"""
from __future__ import annotations

import array
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {
    "miniconv_layer": "miniconv_layer.cu",
    "miniconv_encoder": "miniconv_encoder.cu",
    "flash_attention": "flash_attention.cu",
    "moe_grouped": "moe_grouped.cu",
    "ssd_scan": "ssd_scan.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    return next((c for c in candidates if c and os.access(c, os.X_OK)),
                None)


def cuda_kernels_supported() -> bool:
    """True when the kernels can be built and run here: CUDA present, a
    compute-capability 9.0 (Hopper) card, and nvcc.  Gates the GPU test
    tier; it never chooses a code path."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0)
            and nvcc_path() is not None)


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, dict]:
    """Compile every named library that is not built yet, all in parallel.

    Returns ``{name: {"seconds": float, "log": str}}`` for the libraries
    compiled by this call (``log`` holds ptxas's register and
    shared-memory report).  Raises ``RuntimeError`` with the compiler's
    output if any build fails.
    """
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # repro: allow(timing-warmup) -- times nvcc's compiles: host processes, no device work in the window
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        final = library_path(n)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    out, failed = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))  # atomic: processes may build at once
        out[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def launcher(lib: str, symbol: str):
    """The C launch function ``symbol`` of library ``lib``, typed: it
    takes the address of an int64 array and returns a ``cudaError_t`` as
    an int."""
    fn = getattr(load(lib), symbol)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(library: str, what: str, dev: torch.device,
           args: array.array) -> None:
    """Launch ``library``'s kernel on ``dev``'s current stream.

    ``args`` is the int64 array of the source's ``enum Arg`` without its
    last two slots; this appends the device index and the raw stream,
    calls ``<library>_launch`` and raises, naming ``what``, when it
    returns a CUDA error.  The call converts one argument, not one per
    field, and reads the stream with torch's own accessor, as its
    generated code does: ``.cuda_stream`` of ``torch.cuda.current_stream``
    builds a Stream object first, about fifty times the raw read's host
    time (``benchmarks/conv_tiles.py`` times both).
    """
    index = dev.index or 0
    args.append(index)
    args.append(torch._C._cuda_getCurrentRawStream(index))
    fn = launcher(library, f"{library}_launch")
    check_rc(fn(args.buffer_info()[0]), what)


def check_rc(rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} CUDA launch failed: error {rc} "
                           f"(cudaError_t)")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernels' vector loads
    need (copied only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def on_one_device(*tensors) -> torch.device:
    """The device every given tensor lies on; raises when they differ or
    when it is neither the CPU nor CUDA."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors must share one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["BUILD_DIR", "SOURCES", "aligned", "build", "check_rc",
           "cuda_kernels_supported", "launch", "launcher", "library_path",
           "load", "nvcc_path", "on_one_device"]
