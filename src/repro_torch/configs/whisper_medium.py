"""whisper-medium  [audio]  [arXiv:2212.04356]

24L (decoder) + 24L (encoder) d_model=1024 16H (kv=16) d_ff=4096
vocab=51865 — encoder-decoder; the mel+conv frontend is a STUB
(``input_specs`` provides 1500 precomputed frame embeddings).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    pattern=("attn",),
    n_pattern=24,
    qkv_bias=True,
    mlp="gelu",
    norm="layernorm",
    tie_embeddings=True,
    n_frontend_tokens=1500,
    n_encoder_layers=24,
    # kv=16 divides the model axis: head-sharded cache + DUS decode is
    # already gather-free (see qwen2-moe note)
    masked_cache_update=False,
)
