"""Param specs, the parameter tree, norms and RoPE.

Counterpart of the JAX package's ``models/common.py``. Parameters are
declared as a tree of ``ParamSpec`` (shape + logical axes + init law),
materialised by ``init_params`` on an explicit ``torch.Generator`` with the
same laws as the JAX package (truncated normal scaled by fan-in, ones for
norms, the SSM's ``A_log`` and ``dt`` bias laws in fp32), and held in a
``ParamTree``: an ``nn.Module`` whose attributes mirror the JAX pytree's
keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Any, ...]           # logical axis name (or None) per dim
    init: str = "normal"            # normal | zeros | ones | ssm_a | ssm_dt

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and a request for CUDA on a machine without it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU with the kernels' plain versions")
    return device


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_params(spec_tree, generator: torch.Generator, dtype=torch.bfloat16,
                device="cpu"):
    """Materialise a spec tree into a tree of tensors. Normal leaves draw a
    truncated normal in [-2, 2] in fp32, scaled by 1/sqrt(fan_in), then cast;
    norm scales are ones; ``ssm_a`` is log(uniform[1, 16]) and ``ssm_dt``
    softplus^-1(log-uniform[1e-3, 1e-1]), both kept in fp32 whatever
    ``dtype`` is, as in the JAX package. The draws come from ``generator``
    (a ``torch.Generator`` on ``device``), so the numbers differ from the
    JAX package's threefry draws while the laws agree."""
    def uniform(s: ParamSpec):
        u = torch.empty(s.shape, dtype=torch.float32, device=device)
        return u.uniform_(generator=generator)

    def mk(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        if s.init == "ssm_a":
            return torch.log(1.0 + 15.0 * uniform(s))
        if s.init == "ssm_dt":
            dt = torch.exp(uniform(s) * (np.log(0.1) - np.log(1e-3))
                           + np.log(1e-3))
            return torch.log(torch.expm1(dt))
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = 1.0 / np.sqrt(max(fan_in, 1))
        w = torch.empty(s.shape, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (w * std).to(dtype)
    return tree_map(mk, spec_tree)


class ParamTree(nn.Module):
    """Parameters held under the JAX pytree's key names: a dict becomes a
    child ``ParamTree``, a list an ``nn.ModuleList``, a tensor a frozen
    ``nn.Parameter``."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))


# ---------------------------------------------------------------- numerics --

class _RMSNorm(torch.autograd.Function):
    """The JAX package's ``rms_norm`` with its ``custom_vjp``: fp32 only in
    the (..., 1) row statistics, in both directions; every (..., D) tensor
    stays in the activation dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        var = x.float().square().mean(-1, keepdim=True)
        inv32 = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, inv32, scale)
        return x * inv32.to(x.dtype) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, inv32, scale = ctx.saved_tensors
        d = x.shape[-1]
        dyg = dy * scale.to(dy.dtype)
        t = (dyg * x).float().sum(-1, keepdim=True)
        coef = (inv32 ** 3 * (t / d)).to(x.dtype)
        dx = dyg * inv32.to(dy.dtype) - x * coef
        dscale = ((dy * x).float() * inv32).sum(tuple(range(dy.ndim - 1)))
        return dx, dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm: the variance in fp32, ``inv`` cast to x's dtype before the
    multiply (the JAX package's forward rule); its backward is ``_rms_bwd``'s
    rule (``_RMSNorm``)."""
    return _RMSNorm.apply(x, scale, eps)


def softcap(x: torch.Tensor, cap: float):
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


# (head_dim, theta, device) -> the fp32 frequencies, copied to the device
# once: a decode step captured in a CUDA graph copies nothing from the host
_FREQS: dict = {}


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Half-split
    rotation; angles, sin and cos in fp32, the multiply in x's dtype."""
    hd = x.shape[-1]
    key = (hd, theta, x.device)
    freqs = _FREQS.get(key)
    if freqs is None:
        freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                                device=x.device)
        _FREQS[key] = freqs
    ang = positions[..., :, None, None].float() * freqs   # (..., S, 1, hd/2)
    sin = torch.sin(ang).to(x.dtype)
    cos = torch.cos(ang).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
