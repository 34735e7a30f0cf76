"""qwen3-0.6b  [dense]  [hf:Qwen/Qwen3-8B family — 0.6B variant]

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936 — qk_norm, GQA.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (0.6B card)",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    pattern=("attn",),
    n_pattern=28,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
