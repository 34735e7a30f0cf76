"""--arch <id> -> model instance, as in ``repro.models.registry``.

Dense and VLM-backbone configs build a :class:`DecoderModel`.  Audio
(Whisper), MoE, SSM and hybrid (RG-LRU) families raise
``NotImplementedError``: they come with ROADMAP queue 1, item 10.
``input_specs`` is ``jax.eval_shape``-specific and has no counterpart yet.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import DecoderModel

_NOT_PORTED = ("audio", "moe", "ssm", "hybrid")


def build_model(cfg: ArchConfig) -> DecoderModel:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1, item 10)")
    return DecoderModel(cfg)


def get_model(arch_id: str, *, reduced: bool = False) -> tuple[ArchConfig,
                                                               DecoderModel]:
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    return cfg, build_model(cfg)


__all__ = ["build_model", "get_model"]
