"""Checkpointing: a nested dict of tensors <-> a directory holding
``arrays.npz`` and ``manifest.json`` (port of ``repro.train.checkpoint``).

The on-disk format is the reference's: one npz entry a leaf, keyed by its
``tree_paths`` string; bfloat16 stored as its uint16 bit pattern and named
in the manifest's ``dtypes``; an atomic rename, so a crashed save never
corrupts the latest checkpoint.  A checkpoint therefore crosses between
the two packages in both directions, bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.module import tree_paths

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _to_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, dev: torch.device):
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


def save(path: str, tree: Any, *, step: Optional[int] = None) -> None:
    flat = dict(tree_paths(tree))
    arrays = {}
    dtypes = {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _to_numpy(v)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path))
                           or ".")
    try:
        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"dtypes": dtypes, "step": step,
                       "keys": sorted(arrays)}, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore(path: str, like: Any, *, device: DeviceLike = None) -> Any:
    """Restore into the structure of ``like`` (a nested dict, of tensors
    or of anything, keyed as the saved tree), each leaf a tensor on
    ``device`` (CUDA by default) in its saved dtype."""
    dev = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _ARRAYS)) as loaded:
        flat = {k: _to_tensor(loaded[k], manifest["dtypes"][k], dev)
                for k in manifest["keys"]}

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in t.items()}
        return flat[prefix]

    return build(like, "")


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None


__all__ = ["latest_step", "restore", "save"]
