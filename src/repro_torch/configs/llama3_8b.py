"""llama3-8b  [dense]  [arXiv:2407.21783]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 — GQA, 128k vocab.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama3-8b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    pattern=("attn",),
    n_pattern=32,
    rope_theta=500_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)
