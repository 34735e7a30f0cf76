"""Training launcher (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --steps 100 --batch 4 --seq 128 [--device cpu]

``--reduced`` (the default) trains the CPU-scale variant of the arch
family; ``--full`` trains it at its published width.  Runs on the GPU
unless ``--device cpu`` is given.  VLM configs get stub frontend
embeddings prepended, and the audio family (Whisper) stub encoder frames
(``data.frontend_batches``).  Exits 0 when the last
logged loss is below the first.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.configs import ARCHS
from repro_torch.data import frontend_batches, lm_batches
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None, *, params=None, report: Optional[dict] = None) -> int:
    """The command line.  A caller that already holds the model's
    parameters may pass them as ``params`` (they are not modified) instead
    of the draw from seed 0; ``report``, when given, receives the
    ``history``, the trained ``params``, the ``trainer`` and the
    ``data`` iterator."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, _ = get_model(args.arch, reduced=args.reduced)
    tcfg = TrainConfig(batch=args.batch, steps=args.steps, lr=args.lr,
                       ckpt_dir=args.ckpt)
    trainer = Trainer(cfg, tcfg, device=dev)

    tokens = lm_batches(cfg.vocab, args.batch, args.seq, device=dev)
    if cfg.family in ("vlm", "audio"):
        fronts = frontend_batches(args.batch, cfg.n_frontend_tokens,
                                  cfg.d_model, device=dev)
        data = ({"tokens": next(tokens)["tokens"],
                 "frontend_embeds": next(fronts)} for _ in iter(int, 1))
    else:
        data = tokens

    print(f"training {args.arch} (reduced={args.reduced}) on {dev} for "
          f"{args.steps} steps")
    trained, _, history = trainer.run(
        data, params=params, hook=lambda i, m: print(
            f"  step {i:>5} loss {m['loss']:.4f} wall {m['wall_s']:.1f}s"))
    if report is not None:
        report.update(history=history, params=trained, trainer=trainer,
                      data=data)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f}")
    return 0 if last < first else 1


__all__ = ["main"]


if __name__ == "__main__":
    sys.exit(main())
