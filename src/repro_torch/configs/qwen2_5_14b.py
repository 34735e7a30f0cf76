"""qwen2.5-14b  [dense]  [hf:Qwen/Qwen2.5-0.5B card family — 14B variant]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 — GQA, QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B (14B card)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    pattern=("attn",),
    n_pattern=48,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)
