"""Architecture registry of the configs the port runs: ``--arch <id>``
resolves through ``get_config`` (``<id>-smoke`` gives the reduced config)."""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, SHARED_ATTN,
                                      ModelConfig, ShapeConfig, smoke_config)
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.phi4_mini_3p8b import CONFIG as _phi4

ARCHS = {c.name: c for c in [_phi4, _mamba2]}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_config(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]
