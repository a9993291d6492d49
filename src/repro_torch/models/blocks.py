"""Pre-norm residual blocks. Counterpart of the JAX package's
``models/blocks.py``: the ATTN and LOCAL_ATTN kinds with an MLP, on the
serving paths (decode on dense rings or the paged pool, chunked prefill
into either) and in the full-sequence forward of the training path, and
the MAMBA kind's full-sequence forward. MoE and cross-attention blocks are
not ported; Mamba serving is ROADMAP.md queue 1 item 4."""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, SHARED_ATTN,
                                      ModelConfig)
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


def block_forward(kind: str, params, h, positions, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE, *, causal: bool = True):
    """Full-sequence block (the training forward). h: (B,S,D); positions:
    (B,S). Returns (h, aux_loss). An attention block runs its attention in
    ``window`` mode for LOCAL_ATTN, else ``causal`` (``full`` when
    ``causal`` is False), with the ``kv_keep_stride`` knob, then the MLP at
    the knob's matmul precision."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    prec = knobs.matmul_precision
    if kind == MAMBA:
        y = mamba_mod.mamba_mixer(params.mixer,
                                  rms_norm(h, params.norm, cfg.norm_eps),
                                  cfg, precision=prec)
        return h + y, aux
    mode = ("window" if kind == LOCAL_ATTN else
            ("causal" if causal else "full"))
    h = h + attn_mod.attention(
        params.attn, rms_norm(h, params.norm_attn, cfg.norm_eps), positions,
        cfg, mode=mode, kv_keep_stride=knobs.kv_keep_stride)
    hn = rms_norm(h, params.norm_mlp, cfg.norm_eps)
    return h + mlp_mod.mlp(params.mlp, hn, precision=prec), aux


def _kv_args(kind: str, cfg: ModelConfig, knobs: ApproxKnobs):
    window = cfg.window if kind == LOCAL_ATTN else 0
    kv_scale = attn_mod.KV_SCALE if knobs.kv_quant else 0.0
    return window, kv_scale


def refuse_unported(kind: str) -> None:
    if kind in (MAMBA, SHARED_ATTN):
        raise NotImplementedError(
            f"serving a {kind} block is not ported (ROADMAP.md queue 1, "
            "item 4 'Mamba serving and hybrids')")


def block_prefill(kind: str, params, h, positions, cache, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE, *, mesh=None):
    """A C-token prompt chunk against a dense ring (chunked admission).
    h: (B,C,D); positions: (B,C) absolute. Under ``mesh`` the attention may
    run the sequence ring. Returns (h, cache)."""
    refuse_unported(kind)
    window, kv_scale = _kv_args(kind, cfg, knobs)
    y, cache = attn_mod.chunk_decode_attention(
        params.attn, rms_norm(h, params.norm_attn, cfg.norm_eps),
        positions, cache, cfg, window=window, kv_scale=kv_scale, mesh=mesh)
    h = h + y
    hn = rms_norm(h, params.norm_mlp, cfg.norm_eps)
    return h + mlp_mod.mlp(params.mlp, hn,
                           precision=knobs.matmul_precision), cache


def block_prefill_paged(kind: str, params, h, positions, cache,
                        cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        slot: int, mesh=None):
    """One slot's prompt chunk against the shared page pool. h: (1,C,D).
    Under ``mesh`` the attention may run the sequence ring. Returns (h,
    cache)."""
    window, kv_scale = _kv_args(kind, cfg, knobs)
    y, cache = attn_mod.paged_chunk_attention(
        params.attn, rms_norm(h, params.norm_attn, cfg.norm_eps),
        positions, cache, cfg, slot, window=window, kv_scale=kv_scale,
        mesh=mesh)
    h = h + y
    hn = rms_norm(h, params.norm_mlp, cfg.norm_eps)
    return h + mlp_mod.mlp(params.mlp, hn,
                           precision=knobs.matmul_precision), cache


def block_decode(kind: str, params, h, position, cache, cfg: ModelConfig,
                 knobs: ApproxKnobs = PRECISE, *, active=None):
    """Single-token decode on a ``PagedKVCache`` or a dense ``KVCache``
    ring, chosen by the cache's type. Returns (h, cache).

    On the paged pool ``active`` (B,) bool masks per-slot cache writes;
    None = all rows live. The FREEZE contract: for a row with
    ``active=False`` every page the row owns comes back bit-identical,
    because its write is redirected to the never-read null page. A dense
    ring takes no mask: every row writes at the shared cursor."""
    refuse_unported(kind)
    window, kv_scale = _kv_args(kind, cfg, knobs)
    hn = rms_norm(h, params.norm_attn, cfg.norm_eps)
    if isinstance(cache, attn_mod.PagedKVCache):
        y, cache = attn_mod.paged_decode_attention(
            params.attn, hn, position, cache, cfg, window=window,
            kv_scale=kv_scale, active=active)
    else:
        y, cache = attn_mod.decode_attention(
            params.attn, hn, position, cache, cfg, window=window,
            kv_scale=kv_scale)
    h = h + y
    hn = rms_norm(h, params.norm_mlp, cfg.norm_eps)
    return h + mlp_mod.mlp(params.mlp, hn,
                           precision=knobs.matmul_precision), cache
