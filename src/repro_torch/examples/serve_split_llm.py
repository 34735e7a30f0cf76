"""Split-serving an assigned LLM across a bandwidth-shaped link with
batched requests — the paper's architecture generalised to a
datacentre-link boundary — plus the wire-codec ablation (port of the
reference's ``examples/serve_split_llm.py``).

    python -m repro_torch.examples.serve_split_llm --arch qwen3-0.6b \\
        [--device cpu]

It runs the reduced config of ``--arch`` with random weights from seed 0,
splits it after ``--edge-segments`` super-blocks, and for every wire codec
prints the payload's megabytes, its transfer time over a 1 Gb/s link,
the server half's time and how far the logits move from the uncoded
split (top-1 agreement, largest change).  The audio family has no
super-block split and exits, as in the reference.  Runs on the GPU
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS
from repro_torch.core.wire import CODECS, get_codec
from repro_torch.device import resolve_device
from repro_torch.launch.serve import init_params
from repro_torch.models.registry import get_model
from repro_torch.serving.netsim import shaped
from repro_torch.serving.server import PolicyServer


def main(argv=None) -> list[dict]:
    """The command line; returns the table's rows as dicts."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--edge-segments", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8, help="requests/batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, model = get_model(args.arch, reduced=True)
    if cfg.family == "audio":
        raise SystemExit("enc-dec archs use the natural encoder/decoder "
                         "split; see DESIGN.md §5")
    params = init_params(model, dev)
    edge_p, server_p = model.split_params(params, args.edge_segments)
    B, S = args.batch, args.seq
    tokens = torch.randint(3, cfg.vocab, (B, S), dtype=torch.int32,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    with torch.inference_mode():
        hidden = model.edge_forward(edge_p, tokens)
        # reference output for quality accounting
        ref = model.server_forward(server_p, hidden).float()
    hshape = tuple(hidden.shape)
    print(f"{args.arch}: boundary activation {hshape} "
          f"({hidden.numel() * 4 / 1e6:.2f} MB fp32) for {B} batched "
          f"requests")

    print(f"\n{'codec':<14} {'wire MB':>8} {'tx@1Gb/s ms':>12} "
          f"{'server ms':>10} {'top1 agree':>11} {'max |dlogit|':>13}")
    link = shaped(1000)   # 1 Gb/s DCN-class link
    rows = []
    for name in sorted(CODECS):
        codec = get_codec(name)
        payload = codec.encode(hidden)
        wire = codec.wire_bytes(hshape)

        @torch.inference_mode()
        def serve(payload, codec=codec):
            h = codec.decode(payload, dtype=cfg.torch_dtype)
            return model.server_forward(server_p, h)

        t = PolicyServer(serve).measure(payload)
        out = serve(payload).float()
        agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
        dmax = float((out - ref).abs().max())
        tx_ms = link.tx_time(wire) * 1e3
        rows.append(dict(codec=name, wire_bytes=wire, tx_ms=tx_ms,
                         server_ms=t * 1e3, top1_agree=agree,
                         max_dlogit=dmax))
        print(f"{name:<14} {wire / 1e6:>8.2f} {tx_ms:>12.2f} "
              f"{t * 1e3:>10.1f} {agree:>11.3f} {dmax:>13.3f}")

    print("\nthe uint8/int8 rows are the paper's insight at the pod "
          "boundary: 4x less DCN traffic for negligible logit change.")
    return rows


if __name__ == "__main__":
    main()
