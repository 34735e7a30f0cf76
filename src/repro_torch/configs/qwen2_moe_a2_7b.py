"""qwen2-moe-a2.7b  [moe]  [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=151936,
MoE 60 routed experts top-4 + 4 shared experts (fused as one 4x-width
SwiGLU) behind a sigmoid shared-expert gate.
"""
from repro_torch.models.config import ArchConfig, MoEArch

CONFIG = ArchConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    pattern=("attn",),
    n_pattern=24,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    moe=MoEArch(n_experts=60, top_k=4, n_shared_experts=4,
                shared_expert_gate=True),
    # kv=16 divides the model axis: the head-sharded cache + DUS decode
    # is already gather-free; the masked/seq-sharded path would regress
    # it (EXPERIMENTS.md §Roofline-optimised)
    masked_cache_update=False,
)
