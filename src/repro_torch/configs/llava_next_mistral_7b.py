"""llava-next-mistral-7b  [vlm]  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 — Mistral-7B
language backbone; the ViT/SigLIP vision tower + projector is a STUB
(``input_specs`` provides anyres patch embeddings: 5 tiles x 576 = 2880
vision tokens prepended to the text sequence).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    pattern=("attn",),
    n_pattern=32,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    n_frontend_tokens=2880,   # anyres: 4 tiles + base, 576 patches each
)
