"""Mamba2 (SSD) mixer on the training path: projections -> causal depthwise
conv -> SSD scan -> gated RMSNorm -> out_proj. Counterpart of the JAX
package's ``models/mamba2.py`` (``_dims``, ``mamba_specs``, ``_causal_conv``,
``mamba_mixer``); the scan goes through ``kernels.ops.ssd`` (the CUDA
``ssd_scan`` kernel on the card).

Projections are separate matrices (z / x / bc / dt), as in the JAX package,
so the parameter tree converts leaf for leaf.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, rms_norm


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return di, nh, s.d_state


def mamba_specs(cfg: ModelConfig):
    d = cfg.d_model
    di, nh, n = _dims(cfg)
    w = cfg.ssm.conv_width
    return {
        "in_z": ParamSpec((d, di), ("embed", "ssm_inner")),
        "in_x": ParamSpec((d, di), ("embed", "ssm_inner")),
        "in_bc": ParamSpec((d, 2 * n), ("embed", None)),
        "in_dt": ParamSpec((d, nh), ("embed", "ssm_heads")),
        "conv_x": ParamSpec((di, w), ("ssm_inner", None)),
        "conv_bc": ParamSpec((2 * n, w), (None, None)),
        "a_log": ParamSpec((nh,), ("ssm_heads",), init="ssm_a"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="ssm_dt"),
        "gate_norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(u, conv_w):
    """Depthwise causal conv via shifted adds, summed in fp32, from a zero
    history (the serving slice's conv history waits for ``MambaCache``).
    u: (B,S,C); conv_w: (C,W). Returns silu(conv) in u's dtype."""
    W = conv_w.shape[-1]
    B, S, C = u.shape
    history = torch.zeros((B, W - 1, C), dtype=u.dtype, device=u.device)
    padded = torch.cat([history, u], dim=1)              # (B, S+W-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=u.device)
    for j in range(W):
        out = out + padded[:, j:j + S].float() * conv_w[:, j]
    return F.silu(out).to(u.dtype)


def mamba_mixer(params, x, cfg: ModelConfig, *, precision: str = "bf16"):
    """Full-sequence SSD mixer. x: (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    di, nh, n = _dims(cfg)
    mm = kops.matmul(precision)
    z = mm(x, params.in_z)
    xs = _causal_conv(mm(x, params.in_x), params.conv_x)
    bc = _causal_conv(x @ params.in_bc, params.conv_bc)
    dt_raw = x @ params.in_dt
    b, c = torch.split(bc, n, dim=-1)
    xs4 = xs.reshape(B, S, nh, cfg.ssm.head_dim)
    dt = F.softplus(dt_raw.float() + params.dt_bias.float())
    a = -torch.exp(params.a_log.float())
    y = kops.ssd(xs4, dt, a, b, c, chunk=cfg.ssm.chunk,
                 d_skip=params.d_skip)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), params.gate_norm, cfg.norm_eps)
    return mm(y, params.out_proj)
