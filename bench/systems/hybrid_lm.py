"""The system under test for a hybrid LM configuration (granite-4.0-h): the
port's ``DecoderModel``, built by ``models.registry.get_model`` and cut to
the configuration's depth, split at a layer boundary, deciding one tick of
prefill decisions at a time.

A tick takes one batch of prompts whose token ids already lie on the
device and calls the port's ``SplitModel``: ``edge_step_batch`` (the
embedding and the edge's layers, then per-example uint8 quantisation of
the boundary hidden), ``server_step_batch`` (decode, the server's layers,
the final norm and the tied head at the last position alone:
``server_forward(..., last_only=True)``), then copies the logits into a
pinned host buffer.  The MoE's expert ids of every layer are kept on the
device (``nn.moe.recorded_routes``) for the check.  ``dispatch`` enqueues
all of it and ``wait`` blocks until the logits are on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


def _no_span(name):
    return contextlib.nullcontext()


def set_precision(config: dict) -> None:
    """Serve in the precision the configuration states: bf16 weights and
    activations, the SSD scan in float32, TF32 as ``tf32`` says."""
    if config.get("dtype") != "bfloat16":
        raise ValueError(f"{config['name']}: dtype {config.get('dtype')!r};"
                         f" the hybrid LM path serves bfloat16")
    torch.backends.cuda.matmul.allow_tf32 = bool(config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(config.get("tf32", False))


def arch_config(config: dict):
    """The program's ``ArchConfig`` for the configuration file: the
    registered config of ``arch`` with the file's numbers, its layer
    pattern the shortest period of ``layer_types`` repeated to
    ``num_hidden_layers``.  Raises where the file asks for what the program
    does not compute."""
    from repro_torch.models.config import MoEArch, SSMArch
    from repro_torch.models.registry import get_model
    from bench.reference.hybrid_lm import layer_kinds, period
    c = config
    for key, want in (("mamba_conv_bias", True), ("mamba_proj_bias", False),
                      ("attention_bias", False), ("hidden_act", "silu"),
                      ("normalization_function", "rmsnorm"),
                      ("position_embedding_type", "nope"),
                      ("tie_word_embeddings", True)):
        if c[key] != want:
            raise ValueError(f"{c['name']}: {key} {c[key]!r}; the program "
                             f"computes {want!r}")
    base, _ = get_model(c["arch"])
    p = period(c)
    blocks = tuple({"mamba": "ssm", "attention": "attn"}[k]
                   for k in layer_kinds(c)[:p])
    n = c["num_hidden_layers"]
    if c["mamba_n_heads"] * c["mamba_d_head"] != (c["mamba_expand"]
                                                  * c["hidden_size"]):
        raise ValueError(f"{c['name']}: mamba_n_heads x mamba_d_head is not "
                         f"mamba_expand x hidden_size")
    return dataclasses.replace(
        base, n_layers=n, d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"]
        // c["num_attention_heads"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], pattern=blocks,
        n_pattern=n // p, remainder=(), use_rope=False,
        attention_multiplier=c["attention_multiplier"],
        norm_eps=c["rms_norm_eps"],
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=c["residual_multiplier"],
        logits_scaling=float(c["logits_scaling"]), tie_embeddings=True,
        moe=MoEArch(n_experts=c["num_local_experts"],
                    top_k=c["num_experts_per_tok"], n_shared_experts=1,
                    d_ff_shared=c["shared_intermediate_size"], dropless=True),
        ssm=SSMArch(d_state=c["mamba_d_state"], head_dim=c["mamba_d_head"],
                    expand=c["mamba_expand"], n_groups=c["mamba_n_groups"],
                    conv_width=c["mamba_d_conv"],
                    chunk=c["mamba_chunk_size"]),
        ssm_ffn=True, dtype=c["dtype"])


def program_params(inputs: dict) -> dict:
    """The program's parameter tree over the benchmark's weights (the same
    tensors the reference reads; the stacked ones are taken whole, no
    copy)."""
    def mixer(kind, s):
        if kind == "attention":
            return {"norm1": {"scale": s["norm1"]},
                    "attn": {k: {"kernel": s[k]}
                             for k in ("wq", "wk", "wv", "wo")}}
        return {"norm": {"scale": s["norm1"]},
                "ssm": {"in_proj": {"kernel": s["in_proj"]},
                        "conv": {"kernel": s["conv_w"],
                                 "bias": s["conv_b"]},
                        "A_log": s["A_log"], "D": s["D"],
                        "dt_bias": s["dt_bias"],
                        "norm": {"scale": s["gate_norm"]},
                        "out_proj": {"kernel": s["out_proj"]}}}

    scan = {}
    for i, s in enumerate(inputs["stacks"]):
        kind = inputs["kinds"][i]
        scan[f"b{i}_{'attn' if kind == 'attention' else 'ssm'}"] = {
            **mixer(kind, s), "norm2": {"scale": s["norm2"]},
            "moe": {"router": {"kernel": s["router"]},
                    "experts": {"gate": {"kernel": s["w_gate"]},
                                "up": {"kernel": s["w_up"]},
                                "down": {"kernel": s["w_down"]}},
                    "shared": {"gate": {"kernel": s["s_gate"]},
                               "up": {"kernel": s["s_up"]},
                               "down": {"kernel": s["s_down"]}}}}
    return {"embed": {"embedding": inputs["embed"]}, "scan": scan,
            "final_norm": {"scale": inputs["final_norm"]}}


class System:
    """The program for one configuration and cell, on ``device``."""

    def __init__(self, config: dict, cell: dict, device):
        from repro_torch.core.split import make_split_policy
        from repro_torch.kernels import _build
        from repro_torch.kernels.moe_grouped import moe_grouped
        from repro_torch.models.registry import get_model
        from repro_torch.models.transformer import DecoderModel
        from repro_torch.nn import moe
        from bench.reference.hybrid_lm import period
        set_precision(config)
        self.prompts = cell["params"]["frames_per_tick"]
        self.cfg = arch_config(config)
        edge = config["edge_layers"]
        if edge % period(config):
            raise ValueError(f"{config['name']}: edge_layers {edge} is not "
                             f"a whole number of periods")
        self.edge_segments = edge // period(config)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _build.build(["flash_attention", "moe_grouped"])
        self.model = DecoderModel(self.cfg)
        published, _ = get_model(config["arch"])
        same = dataclasses.replace(
            self.cfg, n_layers=published.n_layers,
            n_pattern=published.n_pattern) == published
        self.build_log = (
            f"program: {self.cfg.arch_id}, {self.cfg.n_layers} layers "
            f"({self.cfg.n_pattern} x {len(self.cfg.pattern)}), "
            f"{self.cfg.param_count():,} parameters; "
            + ("the published config but for its depth" if same else
               "widths differ from the published config"),
            f"split: {edge} layers on the edge ({self.edge_segments} "
            f"super-block(s)), uint8 per-prompt codec, the head at the "
            f"last position")
        self.split = make_split_policy(
            lambda prm, tokens: self._stash(self.model.edge_forward(prm,
                                                                    tokens)),
            lambda prm, h: self.model.server_forward(prm, h, last_only=True),
            codec="uint8")
        self._moe = moe
        self._k7 = moe_grouped
        moe.reset_counters()
        self._start = moe_grouped.launches
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
        """The last tick's answers for the check: the payload, each layer's
        expert ids and the boundary hidden the payload was encoded from,
        held where the tick left them (each tick makes new tensors, so a
        reference is no copy and waits for nothing; about 100 MB a kept
        tick at the cell's size), and the logits the host received."""
        p = self.payload
        return {"codes": p["data"], "scale": p["scale"], "zero": p["zero"],
                "logits": self.host.clone(), "routes": list(self.routes),
                "hidden": self.hidden}

    def counters(self) -> dict:
        """The program's counters since this system was built: K7's
        launches, the (token, k) pairs the dropless MoE computed and the
        most rows one expert took in one call."""
        c = self._moe.dropless_counters()
        return {"moe_grouped.launches": self._k7.launches - self._start,
                "moe.routed_rows": c["routed_rows"],
                "moe.max_expert_rows": c["max_expert_rows"]}

    def close(self) -> None:
        """Drop the program's state."""
        self.edge_params = self.server_params = self.payload = None
        self.routes = self.host = self.pool = self.split = None
        self.hidden = None


__all__ = ["System", "arch_config", "program_params", "set_precision"]
