"""Pre-norm residual blocks. Counterpart of the JAX package's
``models/blocks.py``: the ATTN, LOCAL_ATTN and SHARED_ATTN kinds (an
attention block with an MLP; zamba2's shared block runs as full
attention) and the MAMBA kind, on the serving paths (decode on dense rings
or the paged pool with per-slot Mamba rows, chunked prefill into either)
and in the full-sequence forward of the training path. A config with
experts puts an MoE layer (``models/moe.py``, its ``top_k`` from the
``topk_override`` knob) in place of the MLP of its ATTN and LOCAL_ATTN
blocks. A block made with ``cross=True`` (the encoder-decoder's decoder)
adds a cross-attention sublayer between the self-attention and the MLP,
over the encoder's output ``enc_out``; the decode step recomputes its K/V
from ``enc_out`` every step, as the JAX package does. The sublayers pass
their input and output through ``dist.implied``'s hooks, which record the
tensor-parallel all-reduces while the dry-run traces one position (and do
nothing otherwise)."""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, SHARED_ATTN,
                                      ModelConfig)
from repro_torch.dist import implied
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ParamSpec, rms_norm


def block_specs(kind: str, cfg: ModelConfig, *, cross: bool = False):
    d = cfg.d_model
    if kind == MAMBA:
        return {"norm": ParamSpec((d,), ("embed",), init="ones"),
                "mixer": mamba_mod.mamba_specs(cfg)}
    assert kind in (ATTN, LOCAL_ATTN, SHARED_ATTN), \
        f"the port has no {kind} block"
    s = {"norm_attn": ParamSpec((d,), ("embed",), init="ones"),
         "attn": attn_mod.attn_specs(cfg),
         "norm_mlp": ParamSpec((d,), ("embed",), init="ones")}
    if cross:
        s["norm_cross"] = ParamSpec((d,), ("embed",), init="ones")
        s["cross"] = attn_mod.attn_specs(cfg)
    if cfg.moe is not None and kind in (ATTN, LOCAL_ATTN):
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_mod.mlp_specs(cfg)
    return s


def ffn(params, hn, cfg: ModelConfig, knobs: ApproxKnobs, *, ep_axis=None,
        mesh=None):
    """The block's MLP, or its MoE layer at the knob's ``top_k`` (expert
    parallel over ``mesh``'s ``ep_axis`` when given). Returns (y, aux),
    aux None for an MLP."""
    if hasattr(params, "moe"):
        return moe_mod.moe(params.moe, hn, cfg, top_k=knobs.topk_override,
                           precision=knobs.matmul_precision,
                           ep_axis=ep_axis, mesh=mesh)
    y = mlp_mod.mlp(params.mlp, implied.col_in(hn, "mlp"),
                    precision=knobs.matmul_precision)
    return implied.row_out(y, "mlp"), None


def cross_attention(params, h, enc_out, cfg: ModelConfig):
    """The cross sublayer's residual term: attention from h (B,S,D) over
    ``enc_out`` (B,F,D), no mask and no RoPE."""
    hn = implied.col_in(rms_norm(h, params.norm_cross, cfg.norm_eps), "attn")
    return implied.row_out(attn_mod.attention(
        params.cross, hn, None, cfg, mode="cross", kv_x=enc_out), "attn")


def block_forward(kind: str, params, h, positions, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE, *, causal: bool = True,
                  enc_out=None, ep_axis=None, mesh=None):
    """Full-sequence block (the training forward). h: (B,S,D); positions:
    (B,S). Returns (h, aux_loss). An attention block runs its attention in
    ``window`` mode for LOCAL_ATTN, else ``causal`` (``full`` when
    ``causal`` is False), with the ``kv_keep_stride`` knob, then, given
    ``enc_out``, the cross sublayer, then the MLP at the knob's matmul
    precision (or the MoE layer, expert parallel over ``mesh``'s
    ``ep_axis`` when given, whose load-balancing loss is the aux)."""
    if kind == MAMBA:
        hn = implied.col_in(rms_norm(h, params.norm, cfg.norm_eps), "ssm")
        y = mamba_mod.mamba_mixer(params.mixer, hn, cfg,
                                  precision=knobs.matmul_precision)
        return (h + implied.row_out(y, "ssm"),
                torch.zeros((), dtype=torch.float32, device=h.device))
    mode = ("window" if kind == LOCAL_ATTN else
            ("causal" if causal else "full"))
    hn = implied.col_in(rms_norm(h, params.norm_attn, cfg.norm_eps), "attn")
    h = h + implied.row_out(attn_mod.attention(
        params.attn, hn, positions, cfg, mode=mode,
        kv_keep_stride=knobs.kv_keep_stride), "attn")
    if enc_out is not None:
        h = h + cross_attention(params, h, enc_out, cfg)
    y, aux = ffn(params, rms_norm(h, params.norm_mlp, cfg.norm_eps), cfg,
                 knobs, ep_axis=ep_axis, mesh=mesh)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def _kv_args(kind: str, cfg: ModelConfig, knobs: ApproxKnobs):
    window = cfg.window if kind == LOCAL_ATTN else 0
    kv_scale = attn_mod.KV_SCALE if knobs.kv_quant else 0.0
    return window, kv_scale


def block_prefill(kind: str, params, h, positions, cache, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE, *, mesh=None):
    """A C-token prompt chunk against a dense ring or a ``MambaCache``
    (chunked admission). h: (B,C,D); positions: (B,C) absolute. Under
    ``mesh`` the attention may run the sequence ring. Returns (h, cache),
    the cache updated in place."""
    if kind == MAMBA:
        y, cache = mamba_mod.mamba_prefill(
            params.mixer, rms_norm(h, params.norm, cfg.norm_eps), cache,
            cfg, precision=knobs.matmul_precision)
        return h + y, cache
    window, kv_scale = _kv_args(kind, cfg, knobs)
    y, cache = attn_mod.chunk_decode_attention(
        params.attn, rms_norm(h, params.norm_attn, cfg.norm_eps),
        positions, cache, cfg, window=window, kv_scale=kv_scale, mesh=mesh)
    h = h + y
    y, _ = ffn(params, rms_norm(h, params.norm_mlp, cfg.norm_eps), cfg, knobs)
    return h + y, cache


def block_prefill_paged(kind: str, params, h, positions, cache,
                        cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        slot: int, mesh=None):
    """One slot's prompt chunk against the shared page pool, or against
    the slot's row of the per-slot Mamba rows (taken out, advanced, put
    back). h: (1,C,D). Under ``mesh`` the attention may run the sequence
    ring. Returns (h, cache), the cache updated in place."""
    if kind == MAMBA:
        row = mamba_mod.MambaCache(*(x[slot:slot + 1] for x in cache))
        y, _ = mamba_mod.mamba_prefill(
            params.mixer, rms_norm(h, params.norm, cfg.norm_eps), row,
            cfg, precision=knobs.matmul_precision)
        return h + y, cache
    window, kv_scale = _kv_args(kind, cfg, knobs)
    y, cache = attn_mod.paged_chunk_attention(
        params.attn, rms_norm(h, params.norm_attn, cfg.norm_eps),
        positions, cache, cfg, slot, window=window, kv_scale=kv_scale,
        mesh=mesh)
    h = h + y
    y, _ = ffn(params, rms_norm(h, params.norm_mlp, cfg.norm_eps), cfg, knobs)
    return h + y, cache


def block_decode(kind: str, params, h, position, cache, cfg: ModelConfig,
                 knobs: ApproxKnobs = PRECISE, *, active=None, enc_out=None,
                 shards=1):
    """Single-token decode on a ``PagedKVCache``, a dense ``KVCache`` ring
    or a ``MambaCache``, chosen by the kind and the cache's type. Returns
    (h, cache), the cache updated in place.

    On the paged pool and the Mamba rows ``active`` (B,) bool masks
    per-slot cache writes; None = all rows live. The FREEZE contract: for
    a row with ``active=False`` every page and Mamba row the row owns
    comes back bit-identical, because its page write is redirected to the
    never-read null page and its Mamba update is where-masked. A dense
    ring takes no mask: every row writes at the shared cursor. Given
    ``enc_out`` the cross sublayer follows the self-attention. ``shards``
    is the paged decode's plan (``attention.paged_decode_attention``)."""
    if kind == MAMBA:
        y, cache = mamba_mod.mamba_decode(
            params.mixer, rms_norm(h, params.norm, cfg.norm_eps), cache,
            cfg, precision=knobs.matmul_precision, active=active)
        return h + implied.row_out(y, "ssm"), cache
    window, kv_scale = _kv_args(kind, cfg, knobs)
    hn = rms_norm(h, params.norm_attn, cfg.norm_eps)
    if isinstance(cache, attn_mod.PagedKVCache):
        y, cache = attn_mod.paged_decode_attention(
            params.attn, hn, position, cache, cfg, window=window,
            kv_scale=kv_scale, active=active, shards=shards)
    else:
        y, cache = attn_mod.decode_attention(
            params.attn, hn, position, cache, cfg, window=window,
            kv_scale=kv_scale)
    h = h + implied.row_out(y, "attn")
    if enc_out is not None:
        h = h + cross_attention(params, h, enc_out, cfg)
    y, _ = ffn(params, rms_norm(h, params.norm_mlp, cfg.norm_eps), cfg, knobs)
    return h + y, cache
