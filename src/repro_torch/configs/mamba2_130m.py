"""mamba2-130m  [ssm]  [arXiv:2405.21060 (SSD / state-space duality)]

24L d_model=768, attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.models.config import ArchConfig, SSMArch

CONFIG = ArchConfig(
    arch_id="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=1,        # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,           # no MLP — the SSM block is the mixer
    vocab=50280,
    pattern=("ssm",),
    n_pattern=24,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMArch(d_state=128, head_dim=64, expand=2, n_groups=1,
                conv_width=4, chunk=256),
)
