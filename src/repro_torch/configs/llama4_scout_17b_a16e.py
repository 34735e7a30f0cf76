"""llama4-scout-17b-a16e  [moe]  [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 routing + 1 shared expert per layer (early-fusion multimodal in the
full model; the text backbone is what is assigned here).
"""
from repro_torch.models.config import ArchConfig, MoEArch

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    pattern=("attn",),
    n_pattern=48,
    rope_theta=500_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    moe=MoEArch(n_experts=16, top_k=1, n_shared_experts=1),
)
