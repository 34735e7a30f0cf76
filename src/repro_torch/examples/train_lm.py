"""End-to-end LM training example (port of the reference's
``examples/train_lm.py``): a ~100M-parameter model, a few hundred steps on
the synthetic pipeline, with checkpointing and restore.

    python -m repro_torch.examples.train_lm --steps 200 [--device cpu]

Trains on the GPU unless ``--device cpu`` is given.  The checkpoint is
written in the reference's format, so the reference's ``restore`` reads
it too.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_batches
from repro_torch.device import resolve_device
from repro_torch.nn.module import param_count
from repro_torch.train import checkpoint
from repro_torch.train.trainer import TrainConfig, Trainer


def hundred_m_config():
    """qwen3 family scaled to ~100M params."""
    return dataclasses.replace(
        get_config("qwen3-0.6b"), n_layers=10, n_pattern=10, d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560, vocab=49152,
        dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = hundred_m_config()
    ckpt_dir = args.ckpt or os.path.join(tempfile.gettempdir(),
                                         "repro_lm_ckpt")
    trainer = Trainer(cfg, TrainConfig(
        batch=args.batch, steps=args.steps, lr=6e-4, warmup=20,
        log_every=20, ckpt_dir=ckpt_dir, remat=False), device=dev)
    params, opt_state = trainer.init()
    print(f"model: {param_count(params) / 1e6:.1f}M params "
          f"(analytic {cfg.param_count() / 1e6:.1f}M) on {dev}")

    data = lm_batches(cfg.vocab, args.batch, args.seq, device=dev)
    params, _, hist = trainer.run(
        data, params=params, opt_state=opt_state, hook=lambda i, m: print(
            f"  step {i:>5} loss {m['loss']:.4f} ({m['wall_s']:.0f}s)"))

    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; "
          f"checkpoint at {ckpt_dir} (step {checkpoint.latest_step(ckpt_dir)})")
    restored = checkpoint.restore(ckpt_dir, {"params": params},
                                  device=dev)["params"]
    batch = next(data)
    model = trainer.model
    with torch.no_grad():
        l1, _ = model.loss(params, batch, remat=False)
        l2, _ = model.loss(restored, batch, remat=False)
    if abs(float(l1) - float(l2)) >= 1e-5:
        raise RuntimeError(f"restore mismatch: loss {float(l1)} before, "
                           f"{float(l2)} after")
    print("checkpoint restore verified (loss identical)")
    return {"history": hist, "loss": float(l1), "restored_loss": float(l2),
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
