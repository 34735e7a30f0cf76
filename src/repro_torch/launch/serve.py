"""Split-policy serving launcher on an assigned LLM (port of
``repro.launch.serve``).

Partitions a transformer at a super-block boundary, quantises the
boundary activation with a wire codec, and measures end-to-end decision
latency for split vs server-only execution across a bandwidth sweep — the
paper's Table 5 protocol with the model as the workload.  Dense, MoE,
SSM and hybrid configs serve; every attention core that
``nn.attention.flash_eligible`` admits runs through K5 on the card (a
logit softcap, as recurrentgemma-9b's, keeps its cores eager, as in the
reference).  The audio family (whisper-medium) has no super-block split
and exits, as in the reference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --edge-segments 1 --codec uint8 --bandwidths 10,25,50,100

``--reduced`` is declared as in the reference (``store_true`` with
``default=True``), so the command line always runs the reduced model;
full width is ``build_split(..., reduced=False)``.  ``--device cpu`` runs
the plain versions on the CPU; the default is ``cuda``.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import ARCHS
from repro_torch.core.wire import get_codec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving.client import DecisionLoop, EdgeClient
from repro_torch.serving.netsim import shaped
from repro_torch.serving.server import PolicyServer


def init_params(model, device: DeviceLike = None):
    """``build_split``'s random weights: seed 0 of a generator on the
    device the parameters go to (a 14 B-parameter model is drawn in
    seconds there, in minutes on the host)."""
    dev = resolve_device(device)
    return model.init(torch.Generator(device=dev).manual_seed(0),
                      device=dev)


def build_split(arch: str, *, reduced: bool, edge_segments: int,
                codec_name: str, batch: int, seq: int,
                device: DeviceLike = None, params=None):
    """The split model with random weights from seed 0 (:func:`init_params`),
    on ``device``; a caller that already holds them may pass ``params``.

    Returns ``(cfg, edge_fn, server_fn, monolith_fn, tokens, wire, raw)``:
    ``edge_fn(tokens) -> payload``, ``server_fn(payload) -> logits``,
    ``monolith_fn(tokens) -> logits``, zero tokens of ``(batch, seq)``,
    and the bytes on the link for the split and the server-only pipeline.
    """
    dev = resolve_device(device)
    cfg, model = get_model(arch, reduced=reduced)
    if cfg.family == "audio":
        raise SystemExit("use the whisper enc/dec split example instead")
    if params is None:
        params = init_params(model, dev)
    edge_p, server_p = model.split_params(params, edge_segments)
    codec = get_codec(codec_name)

    @torch.inference_mode()
    def edge_fn(tokens):
        return codec.encode(model.edge_forward(edge_p, tokens))

    @torch.inference_mode()
    def server_fn(payload):
        h = codec.decode(payload, dtype=cfg.torch_dtype)
        return model.server_forward(server_p, h)

    @torch.inference_mode()
    def monolith_fn(tokens):
        logits, _ = model.forward(params, tokens)
        return logits

    tokens = torch.zeros((batch, seq), dtype=torch.int32, device=dev)
    wire = codec.wire_bytes((batch, seq, cfg.d_model))
    raw = batch * seq * 4     # server-only sends raw token ids (4B each)
    # For LLM serving the "raw observation" is tiny (token ids), so the
    # split trade-off at the first boundary is the reverse of the RL
    # case; the split pays where the server half holds the heavy weights.
    return (cfg, edge_fn, server_fn, monolith_fn, tokens, wire, raw)


def latency_table(edge_s: float, split_s: float, mono_s: float,
                  wire_bytes: int, raw_bytes: int,
                  bandwidths: list[float]) -> list[str]:
    """The decision-latency table ``main`` prints: median closed-loop
    latency of server-only and split execution over each shaped link."""
    lines = [f"{'Mb/s':>8} {'server-only(ms)':>16} {'split(ms)':>11}"]
    for mbps in bandwidths:
        so = DecisionLoop(link=shaped(mbps), server_time_s=mono_s,
                          split=False, payload_bytes=raw_bytes)
        sp = DecisionLoop(link=shaped(mbps), server_time_s=split_s,
                          split=True, edge_time_s=edge_s,
                          payload_bytes=wire_bytes)
        lines.append(f"{mbps:>8.0f} {so.median_latency(100)*1e3:>16.1f} "
                     f"{sp.median_latency(100)*1e3:>11.1f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--edge-segments", type=int, default=1)
    ap.add_argument("--codec", default="uint8")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--bandwidths", default="10,25,50,100")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    (cfg, edge_fn, server_fn, monolith_fn, tokens, wire_bytes,
     raw_bytes) = build_split(
        args.arch, reduced=args.reduced, edge_segments=args.edge_segments,
        codec_name=args.codec, batch=args.batch, seq=args.seq,
        device=args.device)

    client = EdgeClient(encode_fn=edge_fn, wire_bytes=wire_bytes)
    j = client.measure(tokens)
    payload = edge_fn(tokens)
    server = PolicyServer(serve_fn=server_fn)
    s_split = server.measure(payload)
    mono = PolicyServer(serve_fn=monolith_fn)
    s_mono = mono.measure(tokens)

    print(f"{args.arch} split@{args.edge_segments} codec={args.codec}: "
          f"edge {j*1e3:.1f}ms server {s_split*1e3:.1f}ms "
          f"monolith {s_mono*1e3:.1f}ms wire {wire_bytes}B raw {raw_bytes}B")
    for line in latency_table(j, s_split, s_mono, wire_bytes, raw_bytes,
                              [float(x) for x in
                               args.bandwidths.split(",")]):
        print(line)
    return 0


__all__ = ["build_split", "init_params", "latency_table", "main"]


if __name__ == "__main__":
    sys.exit(main())
