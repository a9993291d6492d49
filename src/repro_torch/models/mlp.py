"""SwiGLU MLP with optional int8-quantized matmuls (the Pliant lower-precision
knob): on the int8 rungs every matmul here goes through
``kernels.ops.quantized_matmul`` (the CUDA ``int8_matmul`` kernel on the
card). Counterpart of the JAX package's ``models/mlp.py``."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec


def mlp_specs(cfg: ModelConfig, d_ff: int = 0):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp(params, x, *, precision: str = "bf16"):
    mm = kops.matmul(precision)
    gate = F.silu(mm(x, params.wi_gate))
    up = mm(x, params.wi_up)
    return mm(gate * up, params.wo)
