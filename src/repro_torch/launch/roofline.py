"""Roofline terms of a traced dry-run step, as in
``repro.launch.roofline``.

Per (arch, shape, mesh):

  compute term    = FLOPs_per_chip / peak_FLOP/s
  memory term     = bytes_per_chip / HBM_bw
  collective term = collective_bytes_per_chip / link_bw

The counts come from the port's cost counter (``repro_torch.costs``),
which counts the ops each chip runs on its local shards: the terms are
per-chip seconds already, and the FLOPs times the chip count give the
global figure of the useful-FLOPs ratio.  Where the reference parses
collectives out of the compiled HLO, the counter adds up the operand
bytes of each collective as it runs.

The peaks are an NVIDIA H100 SXM's published rates at its 700 W limit
(NVIDIA data sheet): dense bf16 on the tensor cores, HBM3, and NVLink one
way.  A card set below 700 W runs slower; name its limit beside any time
held against these.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM at a 700 W power limit (published peaks)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per chip, dense
HBM_BW = 3.35e12             # bytes/s per chip
LINK_BW = 450e9              # NVLink bytes/s per chip, each way


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float            # fusion-optimistic HBM traffic
    coll_bytes_per_chip: float
    coll_breakdown: dict[str, int]
    model_flops: float               # 6·N·D (train) / 2·N·D (inference)
    bytes_upper_per_chip: float = 0  # every eager op's bytes
    bytes_floor_per_chip: float = 0  # analytic perfect-fusion floor
    peak_memory_bytes: Optional[int] = None   # the counter's live peak

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def hlo_flops_global(self) -> float:
        """The counted FLOPs of every chip (the reference's name)."""
        return self.flops_per_chip * self.chips

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the compute is
        useful."""
        if self.hlo_flops_global <= 0:
            return float("nan")
        return self.model_flops / self.hlo_flops_global

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "bytes_upper_per_chip": self.bytes_upper_per_chip,
            "bytes_floor_per_chip": self.bytes_floor_per_chip,
            "memory_floor_s": self.bytes_floor_per_chip / HBM_BW,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for inference steps, with
    N = active params (MoE counts routed top-k + shared only)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1     # decode: one token per request
    return 2.0 * n * tokens


def hbm_floor_bytes(cfg, shape, chips: int) -> float:
    """Analytic per-chip HBM-traffic floor: weights + boundary activations
    + KV caches, assuming perfect fusion (flash attention keeps score
    tiles on chip).  The reference's formula, its model axis of 16
    included."""
    P = cfg.param_count()
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    B, S = shape.global_batch, shape.seq_len
    tp = 16  # model axis
    if shape.kind == "train":
        weights = P * 2.0 * 3 / tp          # fwd + bwd + remat reads (bf16)
        opt = P * 4.0 * 4 / chips           # adam m,v read+write (f32, FSDP)
        acts = L * B * S * D * 2.0 * 4 / chips
        logits = 3 * B * S * V * 2.0 / chips
        return weights + opt + acts + logits
    if shape.kind == "prefill":
        weights = P * 2.0 / tp
        acts = L * B * S * D * 2.0 * 2 / chips
        return weights + acts
    # decode: every cached byte is read once per token
    kv = 0.0
    for b in cfg.blocks():
        if b == "attn":
            kv += B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
        elif b == "swa":
            w = min(cfg.sliding_window or S, S)
            kv += B * w * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
        elif b == "ssm":
            s = cfg.ssm
            kv += B * (cfg.d_model * s.expand // s.head_dim) \
                * s.head_dim * s.d_state * 4.0 * 2
        elif b == "rec":
            kv += B * (cfg.rnn_width or D) * 4.0 * 2
    weights = cfg.active_param_count() * 2.0 / tp
    return weights + kv / chips


def analyse(traced, *, arch: str, shape_cfg, mesh_name: str, chips: int,
            cfg) -> Roofline:
    """Roofline terms from a traced step (``steps.StepBundle.trace``: its
    ``counter`` is the cost counter of the trace)."""
    c = traced.counter
    coll = {k: int(v) for k, v in c.coll_breakdown.items()}
    return Roofline(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_chip=float(c.flops), bytes_per_chip=float(c.bytes_fused),
        coll_bytes_per_chip=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops=model_flops(cfg, shape_cfg),
        bytes_upper_per_chip=float(c.bytes_accessed),
        bytes_floor_per_chip=hbm_floor_bytes(cfg, shape_cfg, chips),
        peak_memory_bytes=int(c.peak_bytes),
    )


def fmt_row(r: Roofline) -> str:
    return (f"{r.arch:<24} {r.shape:<12} {r.mesh:<6} "
            f"{r.compute_s:>10.4f} {r.memory_s:>10.4f} "
            f"{r.collective_s:>12.6f} {r.bottleneck:<10} "
            f"{r.useful_flops_ratio:>7.3f} "
            f"{(r.peak_memory_bytes or 0)/2**30:>8.2f}GiB")


HEADER = (f"{'arch':<24} {'shape':<12} {'mesh':<6} "
          f"{'compute_s':>10} {'memory_s':>10} {'collective_s':>12} "
          f"{'bottleneck':<10} {'useful':>7} {'peak/dev':>11}")

__all__ = ["HBM_BW", "HEADER", "LINK_BW", "PEAK_FLOPS",
           "Roofline", "analyse", "fmt_row", "hbm_floor_bytes",
           "model_flops"]
