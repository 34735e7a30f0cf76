"""--arch <id> -> model instance, as in ``repro.models.registry``, and
the input shapes' helpers (``text_len``, ``long_ctx``, ``SHAPE_IDS``).

Dense, MoE, SSM, hybrid (RG-LRU) and VLM-backbone configs build a
:class:`DecoderModel`; audio (Whisper) builds a :class:`WhisperModel`.
``abstract_params`` and ``input_specs(_for)``, the dry-run's
allocation-free stand-ins, come with ROADMAP queue 1, item 2.5.
"""
from __future__ import annotations

from typing import Union

from repro_torch.configs import get_config
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


def text_len(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Token positions left for text once frontend tokens are prepended.

    VLM patch tokens share the sequence budget; the audio encoder's frames
    live in the encoder, so whisper keeps the full decoder length.
    """
    if cfg.family == "vlm":
        return shape.seq_len - cfg.n_frontend_tokens
    return shape.seq_len


def long_ctx(shape_id: str) -> bool:
    return shape_id == "long_500k"


SHAPE_IDS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

__all__ = ["Model", "SHAPE_IDS", "build_model", "get_model", "long_ctx",
           "text_len"]
