"""The yardstick's arithmetic for a multi-head latent attention LM decision
(Moonlight-16B-A3B, DeepSeek-V3's block): the card's bf16 peak, a
decision's operations, and the MLA core's (K5's) operations and bytes.

A frozen copy, so that a change to the program cannot move the bound it
is measured against.  Today ``param_count`` and ``active_param_count``
equal the program's ``ArchConfig`` counts of the same model
(``bench/tests/test_bench_mla.py`` holds them equal): linear weights, the
embedding and the untied head, no norm scale or router bias.
"""
from __future__ import annotations

# Published peaks, dense, at the card's full power limit (NVIDIA H100 SXM
# data sheet): bf16 on the tensor cores, and HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(kind: str):
    """The peaks of the card named ``kind``, or None for an unknown card."""
    return PEAKS.get(kind)


def qk_head_dim(config: dict) -> int:
    return config["qk_nope_head_dim"] + config["qk_rope_head_dim"]


def mla_params(config: dict) -> int:
    """One MLA layer's four projections: q_proj, kv_a_proj_with_mqa,
    kv_b_proj and o_proj."""
    c = config
    D, H, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    return (D * H * qk_head_dim(c) + D * (r + c["qk_rope_head_dim"])
            + r * H * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + H * c["v_head_dim"] * D)


def ffn_params(config: dict, dense: bool, active: bool = False) -> int:
    """A dense layer's SwiGLU, or an MoE layer's router, experts (the top-k
    alone when ``active``) and shared experts."""
    c = config
    D, F = c["hidden_size"], c["moe_intermediate_size"]
    if dense:
        return 3 * D * c["intermediate_size"]
    E = c["num_experts_per_tok"] if active else c["n_routed_experts"]
    return (E * 3 * D * F + D * c["n_routed_experts"]
            + 3 * D * c["n_shared_experts"] * F)


def _layers(config: dict):
    """Whether each layer run is dense (the first first_k_dense_replace)."""
    return [i < config["first_k_dense_replace"]
            for i in range(config["num_hidden_layers"])]


def param_count(config: dict, active: bool = False) -> int:
    """Every parameter of the layers run, the embedding and the head (the
    top-k experts of each MoE alone when ``active``)."""
    c = config
    return (2 * c["vocab_size"] * c["hidden_size"]
            + sum(mla_params(c) + ffn_params(c, dense, active)
                  for dense in _layers(c)))


def active_param_count(config: dict) -> int:
    """The parameters a token uses: the top-k experts of each MoE."""
    return param_count(config, active=True)


def core_flops(config: dict, seq_len: int, prompts: int = 1) -> int:
    """The causal MLA cores' operations over every layer for ``prompts``
    prompts of ``seq_len`` tokens: 2 H (qk_head_dim + v_head_dim) a
    (query, key) pair, S (S + 1) / 2 pairs."""
    c = config
    S = seq_len
    return (prompts * c["num_hidden_layers"] * 2 * c["num_attention_heads"]
            * (qk_head_dim(c) + c["v_head_dim"]) * S * (S + 1) // 2)


def core_bytes(config: dict, seq_len: int, prompts: int = 1) -> int:
    """Bytes the cores must move at the least: each layer's bf16 q, k
    (qk_head_dim a head), v and o (v_head_dim) read or written once."""
    c = config
    per_token = (2 * c["num_attention_heads"]
                 * (qk_head_dim(c) + c["v_head_dim"]))
    return prompts * c["num_hidden_layers"] * seq_len * per_token * 2


def core_bound_s(config: dict, seq_len: int, prompts: int, kind: str):
    """The least time the card could take for the cores of ``prompts``
    prompts: the larger of their operations over the bf16 peak and their
    bytes over the memory bandwidth; None for an unknown card."""
    p = peak(kind)
    if p is None:
        return None
    return max(core_flops(config, seq_len, prompts) / p["bf16_flops"],
               core_bytes(config, seq_len, prompts) / p["hbm_bytes"])


def decision_flops(config: dict, seq_len: int) -> int:
    """Operations of one prefill decision of ``seq_len`` tokens: 2 a
    multiply-add of every active weight but the embedding's and the head's
    a token; the causal cores (:func:`core_flops`); the head at the last
    position (2 D V)."""
    c = config
    D, V = c["hidden_size"], c["vocab_size"]
    dense = 2 * (active_param_count(c) - 2 * V * D) * seq_len
    return dense + core_flops(c, seq_len) + 2 * D * V


__all__ = ["PEAKS", "active_param_count", "core_bound_s", "core_bytes",
           "core_flops", "decision_flops", "ffn_params", "mla_params",
           "param_count", "peak", "qk_head_dim"]
