"""Assigned architecture registry: ``--arch <id>`` resolution.

Every entry reproduces the assignment table exactly; provenance is in
each config module's docstring.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape, shape_applicable
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER
from repro_torch.configs.qwen2_72b import CONFIG as QWEN2
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2
from repro_torch.configs.starcoder2_15b import CONFIG as STARCODER2
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK
from repro_torch.configs.llama32_vision_90b import CONFIG as LLAMA_VISION
from repro_torch.configs.mamba2_2p7b import CONFIG as MAMBA2
from repro_torch.configs.qwen3_moe_235b import CONFIG as QWEN3_MOE
from repro_torch.configs.granite_moe_1b import CONFIG as GRANITE_MOE
from repro_torch.configs.zamba2_1p2b import CONFIG as ZAMBA2

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in (WHISPER, QWEN2, GEMMA2, STARCODER2, DEEPSEEK, LLAMA_VISION,
              MAMBA2, QWEN3_MOE, GRANITE_MOE, ZAMBA2)
}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_arch(name[: -len("-reduced")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells() -> List[tuple]:
    """Every (arch, shape, runnable, skip_reason) assignment cell."""
    cells = []
    for aname in sorted(ARCHS):
        cfg = ARCHS[aname]
        for sname, shape in INPUT_SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            cells.append((aname, sname, ok, why))
    return cells
