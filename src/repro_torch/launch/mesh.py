"""Mesh construction, as in ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group.

``make_production_mesh`` is the dry-run's: the reference forces 256 or
512 host devices for XLA; the port builds the same ``DeviceMesh`` over a
fake process group (``torch.testing._internal.distributed.fake_pg``) of
that many ranks, in which every collective returns at once and moves no
byte.  ``make_host_mesh`` is a real mesh over the one process of a world
of size 1: ``nccl`` on the card, ``gloo`` on the CPU.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def init_fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0), unless one exists.  An existing group of
    another size or backend is refused: a fake group cannot share a
    process with a real one."""
    if dist.is_initialized():
        backend, size = dist.get_backend(), dist.get_world_size()
        if backend != "fake" or size != world_size:
            raise RuntimeError(
                f"a {backend!r} process group of {size} ranks exists; the "
                f"dry-run needs a fake group of {world_size} ranks in a "
                f"process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2 pods = 512 chips when ``multi_pod``.
    The fake group is made here when none exists (of 512 ranks, so that
    both meshes fit it); the single-pod mesh takes its first 256."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = MULTI if multi_pod else SINGLE
    if not dist.is_initialized():
        init_fake_group(math.prod(MULTI[0]))
    n = math.prod(shape)
    have = dist.get_world_size()
    if dist.get_backend() != "fake" or have < n:
        raise RuntimeError(
            f"mesh {shape} needs a fake process group of at least {n} "
            f"ranks; this process has a {dist.get_backend()!r} group of "
            f"{have}")
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device=None):
    """A mesh over this one process (world size 1): ``nccl`` when
    ``device`` is a CUDA device (the default), ``gloo`` on the CPU.  The
    group is made here when none exists; a group of another size is
    refused."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if math.prod(shape) != 1:
        raise ValueError(f"a host mesh holds this one process; got {shape}")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1, **({"device_id": dev} if dev.type == "cuda"
                             else {}))
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"a host mesh needs a world of size 1, not "
                           f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.zeros(shape, dtype=torch.int64),
                      mesh_dim_names=tuple(axes))


def destroy() -> None:
    """Tear down the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["MULTI", "SINGLE", "destroy", "init_fake_group",
           "make_host_mesh", "make_production_mesh"]
