"""Architecture and input-shape configuration (port of
``repro.models.config``).

Every assigned architecture is an :class:`ArchConfig`; the four assigned
input shapes are :class:`ShapeConfig` entries in ``SHAPES``.  A config is
pure data — models are built from it by ``repro_torch.models.registry``.
``dtype`` stays a string; :attr:`ArchConfig.torch_dtype` resolves it.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEArch:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    shared_expert_gate: bool = False
    capacity_factor: float = 1.25
    # the shared experts' width where it is not n_shared_experts x d_ff
    # (granite-4.0-h: one shared expert of 1,536 beside experts of 768)
    d_ff_shared: int = 0
    # every (token, k) pair computed, none dropped, the pairs sorted by
    # expert (nn.moe); its router is ``router``'s
    dropless: bool = False
    # the dropless route's router: "softmax" (a softmax over each token's
    # top-k logits) or "sigmoid_bias" (DeepSeek-V3: sigmoid scores, the
    # top-k chosen by score + a per-expert correction bias, the chosen
    # unbiased scores as gates, over their sum, times ``routed_scaling``)
    router: str = "softmax"
    routed_scaling: float = 1.0

    # fields the JAX package's dataclass lacks (``port_only_dict``)
    PORT_ONLY: ClassVar[tuple] = ("d_ff_shared", "dropless", "router",
                                  "routed_scaling")

    def shared_width(self, d_ff: int) -> int:
        """Width of the one fused shared-expert SwiGLU (0: none)."""
        if not self.n_shared_experts:
            return 0
        return self.d_ff_shared or self.n_shared_experts * d_ff


@dataclasses.dataclass(frozen=True)
class SSMArch:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class MLAArch:
    """Multi-head latent attention's widths (DeepSeek-V3; no query LoRA,
    RoPE on interleaved pairs): ``nn.mla``."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    source: str                  # citation (paper/model card)

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # block composition: ``lead``, then ``pattern`` repeated ``n_pattern``
    # times, then ``remainder``.  Block ids: attn | swa (sliding-window
    # attn) | rec (RG-LRU) | ssm (Mamba-2) | mla (multi-head latent
    # attention).  attn/swa/mla blocks carry the MLP (or MoE); a ``lead``
    # block carries the dense MLP of width ``d_ff_dense`` instead
    # (DeepSeek-V3's first_k_dense_replace layers), and lies on the edge of
    # any split.
    pattern: tuple = ("attn",)
    n_pattern: int = 0
    remainder: tuple = ()
    lead: tuple = ()
    d_ff_dense: int = 0

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True        # False: no positional encoding (NoPE)
    # softmax scale of the scores; None is head_dim ** -0.5
    attention_multiplier: Optional[float] = None
    sliding_window: Optional[int] = None    # window for "swa" blocks
    # long-context decode variant: dense archs run long_500k with this
    # window applied to ALL attn blocks (DESIGN.md §5)
    long_context_window: int = 4096

    # mlp
    mlp: str = "swiglu"          # swiglu | gelu | relu2 | geglu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None
    norm_eps: Optional[float] = None   # None: each norm's own default
    # muP multipliers (granite-4.0-h): the embedding's output times
    # ``embedding_multiplier``, each residual branch times
    # ``residual_multiplier``, the logits over ``logits_scaling``
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    moe: Optional[MoEArch] = None
    ssm: Optional[SSMArch] = None
    mla: Optional[MLAArch] = None
    # ssm blocks carry the MLP (or MoE) after the mixer, as attn blocks do
    ssm_ffn: bool = False
    rnn_width: int = 0           # RG-LRU width (hybrid)

    # modality frontend stubs
    n_frontend_tokens: int = 0   # vlm: patch tokens; audio: encoder frames
    n_encoder_layers: int = 0    # audio enc-dec: encoder depth

    dtype: str = "bfloat16"

    # ------- performance knobs (not architecture) --------------------------
    # Kept field for field so that a config equals the reference's, and
    # read where the reference reads them: the chunked attention path, the
    # MoE (padding, dispatch dtype, expert parallelism under a mesh) and
    # the decode cache write (masked_cache_update, whose sequence-sharded
    # scores act under a mesh).
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_skip_masked_blocks: bool = False   # static causal/window skipping
    windowed_decode_gather: bool = False    # gather-window decode for swa
    remat: bool = True                      # checkpoint each super-block
    moe_group_size: int = 512               # capacity group (tokens)
    moe_pad_experts: bool = False           # pad E to divide the data axis
    moe_expert_parallel: bool = False       # E over "data" (all-to-all)
    moe_dispatch_bf16: bool = False         # dispatch einsums in bf16
    # where() cache write + sequence-sharded decode scores (the
    # reference's default for a sequence-sharded KV cache)
    masked_cache_update: bool = True

    # fields the JAX package's dataclass lacks (``port_only_dict``)
    PORT_ONLY: ClassVar[tuple] = (
        "use_rope", "attention_multiplier", "norm_eps",
        "embedding_multiplier", "residual_multiplier", "logits_scaling",
        "ssm_ffn", "lead", "d_ff_dense", "mla")

    # ---------------- derived -------------------------------------------
    def blocks(self) -> list[str]:
        seq = (list(self.lead) + list(self.pattern) * self.n_pattern
               + list(self.remainder))
        if len(seq) != self.n_layers:
            raise ValueError(f"{self.arch_id}: pattern gives {len(seq)} "
                             f"blocks, n_layers is {self.n_layers}")
        return seq

    @property
    def attention_free(self) -> bool:
        return all(b == "ssm" for b in self.blocks())

    @property
    def subquadratic(self) -> bool:
        """True if no block needs O(S) KV state growth at decode beyond a
        bounded window (SSM/rec states are O(1); swa windows are bounded)."""
        return all(b in ("ssm", "rec", "swa") for b in self.blocks())

    def has_ffn(self, kind: str) -> bool:
        """Whether a block of ``kind`` carries the MLP (or MoE)."""
        return kind in ("attn", "swa", "rec", "mla") or (kind == "ssm"
                                                         and self.ssm_ffn)

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        qk = self.n_heads * self.head_dim
        kv = self.n_kv_heads * self.head_dim
        attn = D * qk + 2 * D * kv + qk * D
        mlp_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        mlp = mlp_mult * D * F
        if self.mla is not None:
            m, H = self.mla, self.n_heads
            mla = (D * H * m.qk_head_dim
                   + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                   + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                   + H * m.v_head_dim * D)
        ffn = mlp
        if self.moe is not None:
            e = self.moe
            ffn = (e.n_experts * mlp_mult * D * F + D * e.n_experts
                   + mlp_mult * D * e.shared_width(F))
        total = V * D  # embedding (tied)
        if not self.tie_embeddings:
            total += V * D
        for i, b in enumerate(self.blocks()):
            if b in ("attn", "swa"):
                total += attn
            elif b == "mla":
                total += mla
            elif b == "rec":
                W = self.rnn_width or D
                total += 2 * D * W + 2 * W * W + W * D
            elif b == "ssm":
                s = self.ssm or SSMArch()
                d_in = s.expand * D
                total += D * (2 * d_in + 2 * s.n_groups * s.d_state
                              + d_in // s.head_dim) + d_in * D
            if i < len(self.lead):
                total += mlp_mult * D * self.d_ff_dense
            elif self.has_ffn(b):
                total += mlp if b == "rec" else ffn
        if self.n_encoder_layers:  # whisper encoder (attn + mlp, layernorm)
            total += self.n_encoder_layers * (attn + mlp)
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        D, F = self.d_model, self.d_ff
        mlp_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        inactive = (e.n_experts - e.top_k) * mlp_mult * D * F
        n_moe_layers = sum(1 for b in self.blocks()[len(self.lead):]
                           if self.has_ffn(b) and b != "rec")
        return self.param_count() - n_moe_layers * inactive

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model<=512, <=4-expert variant for CPU smoke tests."""
        d = min(self.d_model, 256)
        hd = 32
        heads = max(min(self.n_heads, 4), 1)
        kv = max(min(self.n_kv_heads, heads), 1)
        pat = tuple(self.pattern)
        if len(pat) <= 2:
            reps, rem = 2 // len(pat), tuple(pat[: 2 % len(pat)])
        else:  # keep one block of each distinct kind (e.g. rec + swa)
            kinds = list(dict.fromkeys(pat))
            reps, rem = 0, tuple(kinds[:2])
        n_layers = len(self.lead) + reps * len(pat) + len(rem)
        moe = None
        if self.moe:
            moe = dataclasses.replace(self.moe, n_experts=4,
                                      top_k=min(self.moe.top_k, 2),
                                      n_shared_experts=min(
                                          self.moe.n_shared_experts, 1),
                                      d_ff_shared=min(self.moe.d_ff_shared,
                                                      512))
        ssm = dataclasses.replace(self.ssm, d_state=32, head_dim=16,
                                  chunk=8) if self.ssm else None
        mla = dataclasses.replace(
            self.mla, kv_lora_rank=min(self.mla.kv_lora_rank, 64),
            qk_nope_head_dim=min(self.mla.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.mla.qk_rope_head_dim, 16),
            v_head_dim=min(self.mla.v_head_dim, 16)) if self.mla else None
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d, n_heads=heads,
            n_kv_heads=kv, head_dim=hd, d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 1024), pattern=pat, n_pattern=reps,
            remainder=rem, moe=moe, ssm=ssm, mla=mla,
            d_ff_dense=min(self.d_ff_dense, 512),
            rnn_width=min(self.rnn_width, d) if self.rnn_width else 0,
            sliding_window=min(self.sliding_window, 8)
            if self.sliding_window else None,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            dtype="float32")

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]


def as_port_config(cfg) -> ArchConfig:
    """``cfg`` as the port's :class:`ArchConfig`: itself, or a config with
    the same fields (the JAX package's, from which the parity tests build
    the port's models), the port's additions at their defaults."""
    if isinstance(cfg, ArchConfig):
        return cfg
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for key, cls in (("moe", MoEArch), ("ssm", SSMArch), ("mla", MLAArch)):
        if d.get(key) is not None:
            d[key] = cls(**dataclasses.asdict(d[key]))
    return ArchConfig(**d)


def port_only_dict(obj):
    """``dataclasses.asdict(obj)`` as the JAX package's dataclass of the
    same name holds it: each field a class names in its ``PORT_ONLY``
    (the port's additions, such as the muP multipliers) is left out where
    it holds its default, so a config that uses none of them compares
    equal to the reference's, and one that does compares unequal."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(port_only_dict(v) for v in obj)
    if not dataclasses.is_dataclass(obj):
        return obj
    out = {}
    skip = getattr(type(obj), "PORT_ONLY", ())
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in skip and v == f.default:
            continue
        out[f.name] = port_only_dict(v)
    return out
