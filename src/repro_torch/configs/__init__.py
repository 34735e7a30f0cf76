"""Assigned architecture configs (one module per architecture).

Every config cites its source in ``ArchConfig.source``.  ``get_config``
accepts the dashed public arch id (``--arch qwen3-0.6b``).
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig, SHAPES, ShapeConfig

from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_0_6b
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen2_5_14b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4_scout
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.whisper_medium import CONFIG as _whisper_medium
from repro_torch.configs.minitron_8b import CONFIG as _minitron_8b
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava_next
from repro_torch.configs.llama3_8b import CONFIG as _llama3_8b
from repro_torch.configs.granite_4_0_h_small import CONFIG as _granite_4h
from repro_torch.configs.moonlight_16b_a3b import CONFIG as _moonlight

ARCHS: dict[str, ArchConfig] = {
    c.arch_id: c
    for c in [
        _qwen3_0_6b, _recurrentgemma_9b, _qwen2_5_14b, _llama4_scout,
        _mamba2_130m, _whisper_medium, _minitron_8b, _qwen2_moe,
        _llava_next, _llama3_8b, _granite_4h, _moonlight,
    ]
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "SHAPES", "ShapeConfig", "ArchConfig", "get_config"]
