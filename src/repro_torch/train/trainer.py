"""LM trainer: composes model, optimizer, data pipeline, checkpointing
(port of ``repro.train.trainer``).

One training step is eager autograd on ``device`` (CUDA by default):
``torch.autograd.grad`` of the model's ``loss`` (``DecoderModel`` or
``WhisperModel``, as ``build_model`` picks) over every parameter leaf,
then the optimizer's update (``train.optimizer.adamw`` over a cosine
schedule, global-norm clipping at 1.0).  Attention cores take the
eager branches during the step (``nn.attention.needs_autograd``): K5 has
no backward pass.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import build_model
from repro_torch.nn.module import tree_leaves, tree_unflatten
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import Optimizer, adamw, cosine_schedule


@dataclasses.dataclass
class TrainConfig:
    batch: int = 8
    steps: int = 200
    lr: float = 3e-4
    warmup: int = 20
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    remat: bool = False


class Trainer:
    def __init__(self, arch_cfg: ArchConfig, tcfg: TrainConfig, *,
                 optimizer: Optional[Optimizer] = None,
                 device: DeviceLike = None):
        self.cfg = arch_cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build_model(arch_cfg)
        self.optimizer = optimizer or adamw(
            cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.steps),
            clip_norm=1.0)

    def batch_to_device(self, batch: dict) -> dict:
        return {k: v.to(self.device) for k, v in batch.items()}

    def step(self, params, opt_state, batch):
        """One update.  Returns (params, opt_state, metrics): ``loss``
        and the loss's aux (``ce``, and ``moe_aux_loss`` for a decoder) as
        0-d tensors on the device."""
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = self.model.loss(tree_unflatten(params, leaves),
                                        batch, remat=self.tcfg.remat)
            grads = torch.autograd.grad(loss, leaves)
        params, opt_state = self.optimizer.update(
            params, opt_state, tree_unflatten(params, list(grads)))
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in aux.items()}}

    def init(self, seed: int = 0):
        """Parameters drawn from a CPU generator made from ``seed`` (the
        same on every device), and the optimizer's state, on the device."""
        params = self.model.init(torch.Generator().manual_seed(seed),
                                 device=self.device)
        return params, self.optimizer.init(params)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, data: Iterator[dict], *, params=None, opt_state=None,
            hook: Optional[Callable[[int, dict], None]] = None):
        """``tcfg.steps`` steps on batches from ``data``.  Every
        ``log_every`` steps and at the last, a history entry holds the
        metrics as floats, ``step`` and ``wall_s`` (seconds since the
        first step, read after a synchronize).  Checkpoints ``{"params":
        ...}`` every ``ckpt_every`` steps and at the end when ``ckpt_dir``
        is set.  Returns (params, opt_state, history)."""
        if params is None:
            params, opt_state = self.init()
        elif opt_state is None:
            opt_state = self.optimizer.init(params)
        history = []
        self._sync()   # init off the clock; launches are asynchronous
        t0 = time.perf_counter()
        for i in range(self.tcfg.steps):
            batch = self.batch_to_device(next(data))
            params, opt_state, metrics = self.step(params, opt_state, batch)
            if i % self.tcfg.log_every == 0 or i == self.tcfg.steps - 1:
                self._sync()   # wall_s covers finished work
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                m["wall_s"] = time.perf_counter() - t0
                history.append(m)
                if hook:
                    hook(i, m)
            if (self.tcfg.ckpt_dir and self.tcfg.ckpt_every
                    and i and i % self.tcfg.ckpt_every == 0):
                checkpoint.save(self.tcfg.ckpt_dir,
                                {"params": params}, step=i)
        if self.tcfg.ckpt_dir:
            checkpoint.save(self.tcfg.ckpt_dir, {"params": params},
                            step=self.tcfg.steps)
        return params, opt_state, history


__all__ = ["TrainConfig", "Trainer"]
