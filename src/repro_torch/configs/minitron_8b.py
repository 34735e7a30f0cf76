"""minitron-8b  [dense]  [arXiv:2407.14679 (pruned Nemotron-4 15B)]

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000 — squared-ReLU
MLP and LayerNorm per the Nemotron family, untied embeddings.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="minitron-8b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256_000,
    pattern=("attn",),
    n_pattern=32,
    rope_theta=10_000.0,
    mlp="relu2",
    norm="layernorm",
    tie_embeddings=False,
)
