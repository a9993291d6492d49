"""Architecture registry of the ten configs of the JAX package, in its
order: ``--arch <id>`` resolves through ``get_config`` (``<id>-smoke``
gives the reduced config), ``all_cells`` walks the (arch, shape) grid."""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, SHAPES,
                                      SHARED_ATTN, ModelConfig, ShapeConfig,
                                      shape_applicable, smoke_config)
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.mistral_large_123b import CONFIG as _mistral
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.phi4_mini_3p8b import CONFIG as _phi4
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2

ARCHS = {c.name: c for c in [_zamba2, _gemma3, _mistral, _phi4, _gemma2,
                             _whisper, _paligemma, _mamba2, _olmoe,
                             _moonshot]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_config(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) pair with its applicability verdict."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = shape_applicable(arch, shape)
            yield arch, shape, ok, reason
