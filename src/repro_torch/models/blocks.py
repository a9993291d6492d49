"""Pre-norm residual blocks. Counterpart of the JAX package's
``models/blocks.py``: the ATTN and LOCAL_ATTN kinds with an MLP on the
paged serving path (decode and paged chunked prefill), and the MAMBA kind's
full-sequence forward on the training path."""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import ATTN, LOCAL_ATTN, MAMBA, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import ParamSpec, rms_norm


def block_specs(kind: str, cfg: ModelConfig):
    d = cfg.d_model
    if kind == MAMBA:
        return {"norm": ParamSpec((d,), ("embed",), init="ones"),
                "mixer": mamba_mod.mamba_specs(cfg)}
    assert kind in (ATTN, LOCAL_ATTN), f"the port has no {kind} block"
    return {"norm_attn": ParamSpec((d,), ("embed",), init="ones"),
            "attn": attn_mod.attn_specs(cfg),
            "norm_mlp": ParamSpec((d,), ("embed",), init="ones"),
            "mlp": mlp_mod.mlp_specs(cfg)}


def block_forward(kind: str, params, h, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE):
    """Full-sequence block (the training forward). Returns (h, aux_loss).
    The port runs the MAMBA kind here; the dense attention forward waits
    for an attention-arch training slice."""
    if kind != MAMBA:
        raise NotImplementedError(
            f"block_forward: the port trains MAMBA blocks only, not {kind}")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    y = mamba_mod.mamba_mixer(params.mixer,
                              rms_norm(h, params.norm, cfg.norm_eps), cfg,
                              precision=knobs.matmul_precision)
    return h + y, aux


def _kv_args(kind: str, cfg: ModelConfig, knobs: ApproxKnobs):
    window = cfg.window if kind == LOCAL_ATTN else 0
    kv_scale = attn_mod.KV_SCALE if knobs.kv_quant else 0.0
    return window, kv_scale


def block_prefill_paged(kind: str, params, h, positions, cache,
                        cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        slot: int):
    """One slot's prompt chunk against the shared page pool. h: (1,C,D).
    Returns (h, cache)."""
    window, kv_scale = _kv_args(kind, cfg, knobs)
    y, cache = attn_mod.paged_chunk_attention(
        params.attn, rms_norm(h, params.norm_attn, cfg.norm_eps),
        positions, cache, cfg, slot, window=window, kv_scale=kv_scale)
    h = h + y
    hn = rms_norm(h, params.norm_mlp, cfg.norm_eps)
    return h + mlp_mod.mlp(params.mlp, hn,
                           precision=knobs.matmul_precision), cache


def block_decode(kind: str, params, h, position, cache, cfg: ModelConfig,
                 knobs: ApproxKnobs = PRECISE, *, active=None):
    """Single-token decode. Returns (h, cache).

    ``active`` (B,) bool masks per-slot cache writes; None = all rows live.
    The FREEZE contract: for a row with ``active=False`` every page the row
    owns comes back bit-identical, because its write is redirected to the
    never-read null page."""
    window, kv_scale = _kv_args(kind, cfg, knobs)
    hn = rms_norm(h, params.norm_attn, cfg.norm_eps)
    y, cache = attn_mod.paged_decode_attention(
        params.attn, hn, position, cache, cfg, window=window,
        kv_scale=kv_scale, active=active)
    h = h + y
    hn = rms_norm(h, params.norm_mlp, cfg.norm_eps)
    return h + mlp_mod.mlp(params.mlp, hn,
                           precision=knobs.matmul_precision), cache
