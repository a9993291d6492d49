"""Architecture registry of the configs the port runs or prices: ``--arch
<id>`` resolves through ``get_config`` (``<id>-smoke`` gives the reduced
config). ``olmoe-1b-7b`` is priced only: ``models.lm`` refuses to build an
MoE model until MoE is ported."""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, SHAPES,
                                      SHARED_ATTN, ModelConfig, ShapeConfig,
                                      shape_applicable, smoke_config)
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.phi4_mini_3p8b import CONFIG as _phi4
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2

ARCHS = {c.name: c for c in [_phi4, _gemma2, _mamba2, _olmoe,
                                    _zamba2]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_config(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]
