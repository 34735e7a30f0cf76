"""--arch <id> -> model instance; --shape <id> -> abstract inputs, as in
``repro.models.registry``.

Dense, MoE, SSM, hybrid (RG-LRU) and VLM-backbone configs build a
:class:`DecoderModel`; audio (Whisper) builds a :class:`WhisperModel`.
``abstract_params`` and ``input_specs(_for)`` return the dry-run's
stand-ins: tensors on ``torch.device("meta")``, of the shapes and dtypes
the step takes, that allocate nothing (the reference's
``ShapeDtypeStruct``s), so the production mesh can be dry-run on any
host.
"""
from __future__ import annotations

from typing import Any, Union

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.transformer import DecoderModel
from repro_torch.models.whisper import WhisperModel

Model = Union[DecoderModel, WhisperModel]


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "audio":
        return WhisperModel(cfg)
    return DecoderModel(cfg)


def get_model(arch_id: str, *, reduced: bool = False) -> tuple[ArchConfig,
                                                               Model]:
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    return cfg, build_model(cfg)


def abstract_params(model: Model) -> Any:
    """The parameter tree on ``meta``: nothing drawn, nothing allocated."""
    return model.init(torch.Generator(), device="meta")


def text_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Token positions left for text once frontend tokens are prepended.

    VLM patch tokens share the sequence budget; the audio encoder's frames
    live in the encoder, so whisper keeps the full decoder length.
    """
    if cfg.family == "vlm":
        return shape.seq_len - cfg.n_frontend_tokens
    return shape.seq_len


def _frontend_spec(cfg: ArchConfig, batch: int):
    return torch.empty((batch, cfg.n_frontend_tokens, cfg.d_model),
                       dtype=torch.bfloat16, device="meta")


def input_specs(arch_id: str, shape_id: str) -> dict[str, Any]:
    """Abstract inputs for the step the shape lowers.

    train/prefill: {"batch": {tokens[, frontend_embeds]}}
    decode:        {"token", "caches", "index"}
    """
    return input_specs_for(get_config(arch_id), SHAPES[shape_id])


def input_specs_for(cfg: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    B = shape.global_batch

    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {
            "tokens": torch.empty((B, text_len(cfg, shape)),
                                  dtype=torch.int32, device="meta")
        }
        if cfg.family in ("vlm", "audio"):
            batch["frontend_embeds"] = _frontend_spec(cfg, B)
        return {"batch": batch}

    # decode: one new token against a seq_len-deep cache
    caches = build_model(cfg).init_cache(B, shape.seq_len, torch.bfloat16,
                                         device="meta")
    return {
        "token": torch.empty((B, 1), dtype=torch.int32, device="meta"),
        "caches": caches,
        "index": torch.empty((), dtype=torch.int32, device="meta"),
    }


def long_ctx(shape_id: str) -> bool:
    return shape_id == "long_500k"


SHAPE_IDS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

__all__ = ["Model", "SHAPE_IDS", "abstract_params", "build_model",
           "get_model", "input_specs", "input_specs_for", "long_ctx",
           "text_len"]
