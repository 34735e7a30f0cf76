"""The yardstick's arithmetic for a hybrid LM decision (granite-4.0-h): the
card's bf16 peak, a decision's operations, and K7's operations and bytes.

A frozen copy, so that a change to the program cannot move the bound it
is measured against.  Today ``param_count`` and ``active_param_count``
equal the program's ``ArchConfig`` counts of the same model
(``bench/tests/test_bench_lm.py`` holds them equal): linear weights and
the tied embedding, no norm, conv or SSM scalars.
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


def _kinds(config: dict) -> list:
    return config["layer_types"][:config["num_hidden_layers"]]


def mixer_params(config: dict, kind: str) -> int:
    """A Mamba-2 mixer's in_proj and out_proj, or attention's four
    projections."""
    c = config
    D = c["hidden_size"]
    if kind == "attention":
        hd = c.get("head_dim") or D // c["num_attention_heads"]
        q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
        return 2 * D * q + 2 * D * kv
    d_in = c["mamba_expand"] * D
    proj = (2 * d_in + 2 * c["mamba_n_groups"] * c["mamba_d_state"]
            + d_in // c["mamba_d_head"])
    return D * proj + d_in * D


def moe_params(config: dict, active: bool = False) -> int:
    """One layer's router, experts (the top-k alone when ``active``) and
    shared expert."""
    c = config
    D, F = c["hidden_size"], c["intermediate_size"]
    E = c["num_experts_per_tok"] if active else c["num_local_experts"]
    return (E * 3 * D * F + D * c["num_local_experts"]
            + 3 * D * c["shared_intermediate_size"])


def param_count(config: dict) -> int:
    """Every parameter the layers run hold, and the tied embedding."""
    return (config["vocab_size"] * config["hidden_size"]
            + sum(mixer_params(config, k) + moe_params(config)
                  for k in _kinds(config)))


def active_param_count(config: dict) -> int:
    """The parameters a token uses: the top-k experts of each MoE."""
    return (config["vocab_size"] * config["hidden_size"]
            + sum(mixer_params(config, k) + moe_params(config, active=True)
                  for k in _kinds(config)))


def decision_flops(config: dict, seq_len: int) -> int:
    """Operations of one prefill decision of ``seq_len`` tokens: 2 a
    multiply-add of every active weight but the embedding's a token; each
    attention layer's causal scores and weighted sum (4 H head_dim a
    (query, key) pair, S (S + 1) / 2 pairs); each Mamba-2 layer's state
    update and read-out (4 heads P N a token); the tied head at the last
    position (2 D V)."""
    c = config
    D, S = c["hidden_size"], seq_len
    dense = 2 * (active_param_count(c) - c["vocab_size"] * D) * S
    kinds = _kinds(c)
    hd = c.get("head_dim") or D // c["num_attention_heads"]
    attn = (kinds.count("attention") * 4 * c["num_attention_heads"] * hd
            * S * (S + 1) // 2)
    ssm = (kinds.count("mamba") * 4 * c["mamba_n_heads"] * c["mamba_d_head"]
           * c["mamba_d_state"] * S)
    return dense + attn + ssm + 2 * D * c["vocab_size"]


def expert_rows(config: dict, tokens: int) -> int:
    """Routed (token, k) pairs of ``tokens`` tokens over the layers run."""
    return tokens * config["num_experts_per_tok"] * len(_kinds(config))


def expert_flops(config: dict, rows: int) -> int:
    """K7's operations: 6 D F a routed row (gate, up and down)."""
    return 6 * config["hidden_size"] * config["intermediate_size"] * rows


def expert_bytes(config: dict, tokens: int) -> int:
    """Bytes K7 must move at the least for ``tokens`` tokens over the
    layers run: in each layer the bf16 rows read once, every expert's
    three bf16 matrices read once, the float32 output written once."""
    c = config
    D, F, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    rows = tokens * c["num_experts_per_tok"]
    return len(_kinds(c)) * (rows * D * 2 + 3 * E * D * F * 2 + rows * D * 4)


def expert_bound_s(config: dict, tokens: int, kind: str):
    """The least time the card could take for K7's work on ``tokens``
    tokens: the larger of its operations over the bf16 peak and its bytes
    over the memory bandwidth; None for an unknown card."""
    p = peak(kind)
    if p is None:
        return None
    return max(expert_flops(config, expert_rows(config, tokens))
               / p["bf16_flops"], expert_bytes(config, tokens)
               / p["hbm_bytes"])


__all__ = ["PEAKS", "active_param_count", "decision_flops", "expert_bound_s",
           "expert_bytes", "expert_flops", "expert_rows", "mixer_params",
           "moe_params", "param_count", "peak"]
