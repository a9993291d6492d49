"""Mamba2 (SSD) mixer: projections -> causal depthwise conv -> SSD scan ->
gated RMSNorm -> out_proj. Counterpart of the JAX package's
``models/mamba2.py``: the full-sequence ``mamba_mixer`` (training),
``mamba_prefill`` (a prompt chunk continuing from a ``MambaCache``: chunked
admission) and ``mamba_decode`` (the O(1) one-token state update). Every
scan goes through ``kernels.ops.ssd`` (the CUDA ``ssd_scan`` kernel on the
card), the serving ones with the state in and out.

Projections are separate matrices (z / x / bc / dt), as in the JAX package,
so the parameter tree converts leaf for leaf. The serving functions update
the cache tensors in place (a replayed CUDA graph of the decode step reads
and writes the same buffers every replay).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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


class MambaCache(NamedTuple):
    conv_x: torch.Tensor    # (B, W-1, di) trailing conv inputs
    conv_bc: torch.Tensor   # (B, W-1, 2N)
    state: torch.Tensor     # (B, nh, head_dim, d_state) fp32 SSD state


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cpu") -> MambaCache:
    di, nh, n = _dims(cfg)
    w = cfg.ssm.conv_width
    return MambaCache(
        conv_x=torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        conv_bc=torch.zeros((batch, w - 1, 2 * n), dtype=dtype,
                            device=device),
        state=torch.zeros((batch, nh, cfg.ssm.head_dim, n),
                          dtype=torch.float32, device=device))


def _causal_conv(u, conv_w, history=None):
    """Depthwise causal conv, its W taps summed in fp32, after ``history``
    (B, W-1, C) (zeros when None). u: (B,S,C); conv_w: (C,W).
    Returns (silu(conv) in u's dtype, the last W-1 inputs: the next call's
    history)."""
    W = conv_w.shape[-1]
    B, S, C = u.shape
    if history is None:
        history = torch.zeros((B, W - 1, C), dtype=u.dtype, device=u.device)
    padded = torch.cat([history.to(u.dtype), u], dim=1)  # (B, S+W-1, C)
    # the W shifted products in one op (few host launches a layer)
    taps = padded.unfold(1, W, 1).float()                # (B, S, C, W)
    out = (taps * conv_w.float()).sum(-1)
    return F.silu(out).to(u.dtype), padded[:, S:]


def _ssm_inputs(params, x, cfg: ModelConfig, mm, cache=None):
    """The projections and convs of x (B,S,D) after ``cache``'s conv
    histories (zeros when None): (z, xs (B,S,nh,P), dt fp32, a fp32, b, c,
    conv_x tail, conv_bc tail)."""
    B, S, _ = x.shape
    di, nh, n = _dims(cfg)
    z = mm(x, params.in_z)
    xs, hist_x = _causal_conv(mm(x, params.in_x), params.conv_x,
                              None if cache is None else cache.conv_x)
    bc, hist_bc = _causal_conv(x @ params.in_bc, params.conv_bc,
                               None if cache is None else cache.conv_bc)
    dt_raw = x @ params.in_dt
    b, c = torch.split(bc, n, dim=-1)
    dt = F.softplus(dt_raw.float() + params.dt_bias.float())
    a = -torch.exp(params.a_log.float())
    return (z, xs.reshape(B, S, nh, cfg.ssm.head_dim), dt, a, b, c,
            hist_x, hist_bc)


def _gate_out(params, y, z, cfg: ModelConfig, mm):
    y = rms_norm(y * F.silu(z), params.gate_norm, cfg.norm_eps)
    return mm(y, params.out_proj)


def mamba_mixer(params, x, cfg: ModelConfig, *, precision: str = "bf16"):
    """Full-sequence SSD mixer. x: (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    mm = kops.matmul(precision)
    z, xs4, dt, a, b, c, _, _ = _ssm_inputs(params, x, cfg, mm)
    y = kops.ssd(xs4, dt, a, b, c, chunk=cfg.ssm.chunk,
                 d_skip=params.d_skip)
    return _gate_out(params, y.reshape(B, S, -1), z, cfg, mm)


def mamba_with_state(params, x, cfg: ModelConfig, *, cache=None,
                     precision: str = "bf16"):
    """x: (B,S,D) after ``cache`` (a ``MambaCache``; None = a zero state
    and zero conv histories) -> ((B,S,D), the cache after the last token
    as a new ``MambaCache``). The scan runs through ``ops.ssd`` with the
    state in and out (the ``ssd_scan`` kernel on the card, at chunks of
    ``cfg.ssm.chunk``, the last padded to the kernel's tiles). The JAX
    package's ``mamba_prefill`` chunks at the largest divisor of S that is
    at most ``cfg.ssm.chunk``: the same function, summed in other
    orders."""
    B, S, _ = x.shape
    mm = kops.matmul(precision)
    z, xs4, dt, a, b, c, hist_x, hist_bc = _ssm_inputs(params, x, cfg, mm,
                                                      cache)
    y, state = kops.ssd(xs4, dt, a, b, c, chunk=cfg.ssm.chunk,
                        d_skip=params.d_skip,
                        init_state=None if cache is None else cache.state,
                        return_state=True)
    out = _gate_out(params, y.reshape(B, S, -1), z, cfg, mm)
    return out, MambaCache(hist_x, hist_bc, state)


def mamba_prefill(params, x, cache: MambaCache, cfg: ModelConfig, *,
                  precision: str = "bf16"):
    """C-token prompt-chunk step continuing from ``cache``: x (B,C,D) ->
    (B,C,D), the cache advanced in place. A prompt consumed chunk by chunk
    lands in the state C successive ``mamba_decode`` calls produce (the
    chunked admission path)."""
    y, new = mamba_with_state(params, x, cfg, cache=cache,
                              precision=precision)
    for old, t in zip(cache, new):
        old.copy_(t)
    return y, cache


def mamba_decode(params, x, cache: MambaCache, cfg: ModelConfig, *,
                 precision: str = "bf16", active=None):
    """Single-token decode: x (B,1,D) -> (B,1,D), the cache advanced in
    place. ``active`` (B,) bool masks the update per row: a row with
    ``active=False`` keeps its conv histories and SSD state bit for bit
    (``torch.where`` of the new and the old values written back into the
    cache tensors), so a slot another path is building is never advanced
    by a garbage decode token."""
    B, _, D = x.shape
    di, nh, n = _dims(cfg)
    mm = kops.matmul(precision)
    z, xs4, dt, a, b, c, hist_x, hist_bc = _ssm_inputs(params, x, cfg, mm,
                                                      cache)
    xs3 = xs4[:, 0].float()                              # (B, nh, P)
    dt = dt[:, 0]                                        # (B, nh)
    bf, cf = b[:, 0].float(), c[:, 0].float()            # (B, N)
    da = torch.exp(dt * a)
    state = (cache.state * da[..., None, None]
             + (dt[..., None] * xs3)[..., None] * bf[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, cf)
    y = y + params.d_skip.float()[None, :, None] * xs3
    y = y.reshape(B, 1, di).to(x.dtype)
    for old, new in zip(cache, (hist_x, hist_bc, state)):
        if active is not None:
            new = torch.where(active.reshape((B,) + (1,) * (old.dim() - 1)),
                              new.to(old.dtype), old)
        old.copy_(new)
    return _gate_out(params, y, z, cfg, mm), cache
