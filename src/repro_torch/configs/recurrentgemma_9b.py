"""recurrentgemma-9b  [hybrid]  [arXiv:2402.19427 (Griffin); RG-9B card]

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000 —
RG-LRU + local attention in a 1:2 (attn : recurrent) block ratio:
pattern (rec, rec, swa) x 12 + (rec, rec), local window 2048.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256_000,
    pattern=("rec", "rec", "swa"),
    n_pattern=12,
    remainder=("rec", "rec"),
    sliding_window=2048,
    rnn_width=4096,
    rope_theta=10_000.0,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    logit_softcap=30.0,
)
