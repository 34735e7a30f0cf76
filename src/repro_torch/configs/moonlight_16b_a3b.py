"""moonlight-16b-a3b  [moe]  [hf:moonshotai/Moonlight-16B-A3B]

DeepSeek-V3's block at Moonlight's published widths (``model_type``
deepseek_v3).  27L d_model=2048, every layer multi-head latent attention
(``nn.mla``): 16 heads, no query LoRA, ``kv_lora_rank`` 512,
``qk_nope_head_dim`` 128, ``qk_rope_head_dim`` 64 (one RoPE key shared by
all heads, interleaved), ``v_head_dim`` 128, RoPE theta 50,000, scores
scaled by 192 ** -0.5.  Layer 0 (``first_k_dense_replace`` 1) carries a
dense SwiGLU of width 11,264: it is the one ``lead`` block, unrolled before
the 26 stacked ``mla`` blocks (the block pattern's way of saying
first_k_dense_replace).  Layers 1-26 carry a dropless MoE: 64 routed
SwiGLU experts of width 1,408, top-6, routed by DeepSeek-V3's sigmoid
router (``noaux_tc``, one group: the top-6 of the sigmoid scores plus
``e_score_correction_bias``, gates the chosen scores over their sum times
``routed_scaling_factor`` 2.446), and 2 shared experts fused as one
ungated SwiGLU of width 2,816.  RMSNorm eps 1e-5, untied head, vocab
163,840.  15.96 B parameters (param_count): 31.9 GB in bf16, one H100.
"""
from repro_torch.models.config import ArchConfig, MLAArch, MoEArch

CONFIG = ArchConfig(
    arch_id="moonlight-16b-a3b",
    family="moe",
    source="https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/"
           "config.json",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # MLA: every head its own key and value
    head_dim=192,             # qk_nope_head_dim + qk_rope_head_dim
    d_ff=1408,                # moe_intermediate_size: one expert's width
    vocab=163840,
    pattern=("mla",),
    n_pattern=26,
    lead=("mla",),            # first_k_dense_replace 1
    d_ff_dense=11264,         # intermediate_size
    rope_theta=50000.0,
    mlp="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=False,
    moe=MoEArch(n_experts=64, top_k=6, n_shared_experts=2, dropless=True,
                router="sigmoid_bias", routed_scaling=2.446),
    mla=MLAArch(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128),
)
