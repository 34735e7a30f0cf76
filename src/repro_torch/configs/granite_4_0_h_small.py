"""granite-4.0-h-small  [hybrid]  [hf:ibm-granite/granite-4.0-h-small]

40L d_model=4096, 36 Mamba-2 mixers (128 heads x 64, d_state 128, one
group, conv width 4 with a bias, chunk 256) and 4 GQA attention mixers
(32 heads over 8 KV heads, head_dim 128, no positional encoding), in the
order M x5, A, M x4 repeated four times.  Every layer carries an MoE
after its mixer: 72 SwiGLU experts of width 768, top-10 (a softmax over
the top-10 router logits), dropless, and one ungated SwiGLU shared expert
of width 1,536.  muP multipliers: embeddings x12, each residual branch
x0.22, an attention scale of 1/128, logits /16.  RMSNorm eps 1e-5, tied
embeddings, vocab 100,352.  32.2 B parameters (param_count).
"""
from repro_torch.models.config import ArchConfig, MoEArch, SSMArch

CONFIG = ArchConfig(
    arch_id="granite-4.0-h-small",
    family="hybrid",
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/"
           "main/config.json",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,             # hidden_size / num_attention_heads
    d_ff=768,                 # intermediate_size: one expert's width
    vocab=100352,
    # layer_types: attention at layers 5, 15, 25 and 35
    pattern=("ssm",) * 5 + ("attn",) + ("ssm",) * 4,
    n_pattern=4,
    use_rope=False,           # position_embedding_type "nope"
    attention_multiplier=0.0078125,
    mlp="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    moe=MoEArch(n_experts=72, top_k=10, n_shared_experts=1,
                d_ff_shared=1536, dropless=True),
    ssm=SSMArch(d_state=128, head_dim=64, expand=2, n_groups=1,
                conv_width=4, chunk=256),
    ssm_ffn=True,
)
