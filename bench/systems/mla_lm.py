"""The system under test for a multi-head latent attention LM configuration
(Moonlight-16B-A3B, DeepSeek-V3's block): the port's ``DecoderModel``,
built from the registered config by ``models.registry.get_model``, split
at a layer boundary, deciding one tick of prefill decisions at a time.

A tick takes one batch of prompts whose token ids already lie on the
device and calls the port's ``SplitModel``: ``edge_step_batch`` (the
embedding, the dense lead layer and the edge's MoE layers, then
per-example uint8 quantisation of the boundary hidden),
``server_step_batch`` (decode, the server's layers, the final norm and the
untied head at the last position alone: ``server_forward(...,
last_only=True)``), then copies the logits into a pinned host buffer.  The
MoE's expert ids of every layer are kept on the device
(``nn.moe.recorded_routes``) for the check.  ``dispatch`` enqueues all of
it and ``wait`` blocks until the logits are on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

# what the program computes of the published config, key by key
COMPUTES = (("q_lora_rank", None), ("n_group", 1), ("topk_group", 1),
            ("scoring_func", "sigmoid"), ("topk_method", "noaux_tc"),
            ("hidden_act", "silu"), ("attention_bias", False),
            ("moe_layer_freq", 1), ("tie_word_embeddings", False),
            ("ep_size", 1), ("num_nextn_predict_layers", 0),
            ("norm_topk_prob", True))


def _no_span(name):
    return contextlib.nullcontext()


def set_precision(config: dict) -> None:
    """Serve in the precision the configuration states: bf16 weights and
    activations, TF32 as ``tf32`` says."""
    if config.get("dtype") != "bfloat16":
        raise ValueError(f"{config['name']}: dtype {config.get('dtype')!r};"
                         f" the MLA LM path serves bfloat16")
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))


def arch_config(config: dict):
    """The program's ``ArchConfig`` for the configuration file: the
    registered config of ``arch`` with the file's numbers, the first
    ``first_k_dense_replace`` layers as ``lead`` blocks and the rest as
    stacked ``mla`` blocks.  Raises where the file asks for what the
    program does not compute."""
    from repro_torch.models.config import MLAArch, MoEArch
    from repro_torch.models.registry import get_model
    c = config
    for key, want in COMPUTES:
        if c[key] != want:
            raise ValueError(f"{c['name']}: {key} {c[key]!r}; the program "
                             f"computes {want!r}")
    if c["num_key_value_heads"] != c["num_attention_heads"]:
        raise ValueError(f"{c['name']}: MLA gives every head its own key "
                         f"and value; num_key_value_heads "
                         f"{c['num_key_value_heads']}")
    base, _ = get_model(c["arch"])
    n, lead = c["num_hidden_layers"], c["first_k_dense_replace"]
    return dataclasses.replace(
        base, n_layers=n, d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        d_ff=c["moe_intermediate_size"], d_ff_dense=c["intermediate_size"],
        vocab=c["vocab_size"], pattern=("mla",), n_pattern=n - lead,
        lead=("mla",) * lead, remainder=(), rope_theta=float(c["rope_theta"]),
        norm_eps=c["rms_norm_eps"], tie_embeddings=False,
        moe=MoEArch(n_experts=c["n_routed_experts"],
                    top_k=c["num_experts_per_tok"],
                    n_shared_experts=c["n_shared_experts"], dropless=True,
                    router="sigmoid_bias",
                    routed_scaling=c["routed_scaling_factor"]),
        mla=MLAArch(kv_lora_rank=c["kv_lora_rank"],
                    qk_nope_head_dim=c["qk_nope_head_dim"],
                    qk_rope_head_dim=c["qk_rope_head_dim"],
                    v_head_dim=c["v_head_dim"]),
        dtype=c["dtype"])


def program_params(inputs: dict) -> dict:
    """The program's parameter tree over the benchmark's weights (the same
    tensors the reference reads; the stacked ones are taken whole, no
    copy)."""
    def attn(w):
        return {"norm1": {"scale": w["norm1"]},
                "mla": {"q_proj": {"kernel": w["wq"]},
                        "kv_a_proj_with_mqa": {"kernel": w["wkv_a"]},
                        "kv_a_layernorm": {"scale": w["kv_norm"]},
                        "kv_b_proj": {"kernel": w["wkv_b"]},
                        "o_proj": {"kernel": w["wo"]}},
                "norm2": {"scale": w["norm2"]}}

    def swiglu(w, g, u, d):
        return {"gate": {"kernel": w[g]}, "up": {"kernel": w[u]},
                "down": {"kernel": w[d]}}

    s = inputs["stack"]
    params = {"embed": {"embedding": inputs["embed"]},
              "scan": {"b0_mla": {
                  **attn(s),
                  "moe": {"router": {"kernel": s["router"]},
                          "e_score_correction_bias": s["bias"],
                          "experts": swiglu(s, "w_gate", "w_up", "w_down"),
                          "shared": swiglu(s, "s_gate", "s_up", "s_down")}}},
              "final_norm": {"scale": inputs["final_norm"]},
              "lm_head": {"kernel": inputs["lm_head"]}}
    for i, w in enumerate(inputs["lead"]):
        params[f"lead{i}_mla"] = {**attn(w),
                                  "mlp": swiglu(w, "gate", "up", "down")}
    return params


class System:
    """The program for one configuration and cell, on ``device``."""

    def __init__(self, config: dict, cell: dict, device):
        from repro_torch.core.split import make_split_policy
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.moe_grouped import moe_grouped
        from repro_torch.models.registry import get_model
        from repro_torch.models.transformer import DecoderModel
        from repro_torch.nn import mla, moe
        set_precision(config)
        self.prompts = cell["params"]["frames_per_tick"]
        self.cfg = arch_config(config)
        edge, lead = config["edge_layers"], config["first_k_dense_replace"]
        if edge <= lead:
            raise ValueError(f"{config['name']}: edge_layers {edge} leaves no "
                             f"MoE layer on the edge")
        self.edge_segments = edge - lead
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _build.build(["flash_attention", "moe_grouped", "moe_combine"])
        self.model = DecoderModel(self.cfg)
        published, _ = get_model(config["arch"])
        same = self.cfg == published
        self.build_log = (
            f"program: {self.cfg.arch_id}, {self.cfg.n_layers} layers "
            f"({len(self.cfg.lead)} dense + {self.cfg.n_pattern} MoE), "
            f"{self.cfg.param_count():,} parameters; "
            + ("the published config" if same else
               "differs from the published config"),
            f"split: {edge} layers on the edge, uint8 per-prompt codec, the "
            f"untied head at the last position")
        self.split = make_split_policy(
            lambda prm, tokens: self._stash(self.model.edge_forward(prm,
                                                                    tokens)),
            lambda prm, h: self.model.server_forward(prm, h, last_only=True),
            codec="uint8")
        self._moe, self._mla = moe, mla
        self._k5, self._k7 = flash_attention, moe_grouped
        moe.reset_counters()
        mla.reset_counters()
        self._start = (moe_grouped.launches, flash_attention.launches,
                       flash_attention.tc_launches,
                       flash_attention.dv_launches, flash_attention.copies)
        self.payload = self.routes = self.hidden = None

    def _stash(self, hidden):
        """Keep the edge's boundary hidden (a reference, no copy) for the
        check of the codec."""
        self.hidden = hidden
        return hidden

    def bind(self, inputs: dict) -> None:
        """Serve with the benchmark's weights and token ids (the same
        tensors the reference reads)."""
        params = program_params(inputs)
        self.edge_params, self.server_params = self.model.split_params(
            params, self.edge_segments)
        self.pool = inputs["tokens"]
        self.host = torch.empty((self.prompts, self.cfg.vocab),
                                dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")

    def dispatch(self, tick: int, span=_no_span) -> int:
        """Enqueue tick ``tick``; returns the pool batch it decides."""
        idx = tick % self.pool.shape[0]
        routes: list = []
        with torch.inference_mode(), self._moe.recorded_routes(routes):
            with span("edge"):
                payload = self.split.edge_step_batch(self.edge_params,
                                                     self.pool[idx])
            with span("server"):
                logits = self.split.server_step_batch(self.server_params,
                                                      payload)
            with span("fetch"):
                self.host.copy_(logits[:, 0].float(), non_blocking=True)
        self.payload, self.routes = payload, routes
        return idx

    def wait(self) -> None:
        """Block until the last dispatched tick's logits are on the
        host."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def keep(self) -> dict:
        """The last tick's answers for the check: the payload, each MoE
        layer's expert ids and the boundary hidden the payload was encoded
        from, held where the tick left them (each tick makes new tensors,
        so a reference is no copy and waits for nothing; about 105 MB a
        kept tick at the cell's size), and the logits the host received."""
        p = self.payload
        return {"codes": p["data"], "scale": p["scale"], "zero": p["zero"],
                "logits": self.host.clone(), "routes": list(self.routes),
                "hidden": self.hidden}

    def counters(self) -> dict:
        """The program's counters since this system was built: K7's and
        K5's launches (K5's on the tensor cores, with values narrower than
        the keys, and its input copies), the (token, k) pairs the dropless
        MoE computed, the most rows one expert took in one call, and the
        latent cache's bytes read by decode steps."""
        c = self._moe.dropless_counters()
        k7, k5, tc, dv, cp = self._start
        f = self._k5
        return {"moe_grouped.launches": self._k7.launches - k7,
                "flash_attention.launches": f.launches - k5,
                "flash_attention.tc_launches": f.tc_launches - tc,
                "flash_attention.dv_launches": f.dv_launches - dv,
                "flash_attention.copies": f.copies - cp,
                "moe.routed_rows": c["routed_rows"],
                "moe.max_expert_rows": c["max_expert_rows"],
                "mla.cache_bytes": self._mla.mla_counters()["cache_bytes"]}

    def close(self) -> None:
        """Drop the program's state."""
        self.edge_params = self.server_params = self.payload = None
        self.routes = self.host = self.pool = self.split = None
        self.hidden = None


__all__ = ["COMPUTES", "System", "arch_config", "program_params",
           "set_precision"]
