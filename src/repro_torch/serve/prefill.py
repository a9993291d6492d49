"""Prompt admission. Counterpart of the JAX package's ``serve/prefill.py``:
``prefill_chunk`` streams one prompt chunk into dense rings (the dense
engine's admission into a fresh single-request cache),
``paged_prefill_chunk`` one chunk of one slot into the page pool, and
``prefill_with_cache`` runs the full-sequence forward once and hands dense
rings and Mamba states to decode. A Mamba block's scan runs through
``ops.ssd`` with the state in and out (the ``ssd_scan`` kernel on the
card); zamba2's SHARED_ATTN layers run the one ``shared`` block; an MoE
block routes all B * S tokens of the sequence at once."""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import LOCAL_ATTN, MAMBA, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.blocks import block_prefill, block_prefill_paged, ffn
from repro_torch.models.common import apply_rope, rms_norm
from repro_torch.models.lm import layer_cache, layer_params, logits_fn


def _attn_block_with_kv(params, h, positions, cfg: ModelConfig, kind: str,
                        knobs: ApproxKnobs, max_len: int):
    """An attention block over the whole sequence that also returns its
    decode ring: the last ``min(S, W)`` K/V entries in the first slots, at
    the activations' dtype. h: (B,S,D). Returns (h, KVCache)."""
    hn = rms_norm(h, params.norm_attn, cfg.norm_eps)
    B, S, _ = hn.shape
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    k = apply_rope((hn @ params.attn.wk).reshape(B, S, G, hd), positions,
                   cfg.rope_theta)
    v = (hn @ params.attn.wv).reshape(B, S, G, hd)
    mode = "window" if kind == LOCAL_ATTN else "causal"
    h = h + attn_mod.attention(params.attn, hn, positions, cfg, mode=mode,
                               kv_keep_stride=knobs.kv_keep_stride)
    y, _ = ffn(params, rms_norm(h, params.norm_mlp, cfg.norm_eps), cfg, knobs)
    h = h + y
    W = min(cfg.window, max_len) if kind == LOCAL_ATTN else max_len
    n_keep = min(S, W)
    cache = attn_mod.init_cache(cfg, B, W, k.dtype, device=h.device)
    cache.k[:, :n_keep] = k[:, S - n_keep:]
    cache.v[:, :n_keep] = v[:, S - n_keep:]
    cache.pos[:, :n_keep] = torch.arange(S - n_keep, S, dtype=torch.int32,
                                         device=h.device)
    cache.cursor.fill_(n_keep % W)
    return h, cache


def _mamba_block_with_state(params, h, cfg: ModelConfig, knobs: ApproxKnobs):
    """A Mamba block over the whole sequence from a zero state that also
    returns its ``MambaCache`` for decode. h: (B,S,D)."""
    y, cache = mamba_mod.mamba_with_state(
        params.mixer, rms_norm(h, params.norm, cfg.norm_eps), cfg,
        precision=knobs.matmul_precision)
    return h + y, cache


def prefill_chunk(params, tokens, start: int, caches, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE, *, mesh=None):
    """One prompt chunk against dense decode rings (chunked admission).

    tokens: (B, C); ``start`` is the chunk's first absolute position;
    caches: the ``lm.init_caches`` layout. Each layer's chunk attends over
    its ring and itself, then enters the ring; under ``mesh`` the attention
    may run the sequence ring. Returns (last-token logits (B,V) fp32,
    caches), the caches updated in place."""
    h = params.embed[tokens]
    B, C, _ = h.shape
    positions = start + torch.arange(C, device=h.device).expand(B, C)
    for i, kind in enumerate(cfg.kinds()):
        h, _ = block_prefill(kind, layer_params(params, cfg, i), h,
                             positions, layer_cache(caches, cfg, i), cfg,
                             knobs, mesh=mesh)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_fn(params, h[:, -1], cfg), caches


def paged_prefill_chunk(params, tokens, start: int, caches, slot: int,
                        cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                        mesh=None):
    """One prompt chunk for ONE slot of the paged engine caches.

    tokens: (1, C); ``start`` is the chunk's first absolute position. The
    chunk's K/V go straight into the page pool through the slot's block
    table (prefix-shared pages are simply already mapped); under ``mesh``
    each layer's attention may run the sequence ring. Returns (last-token
    logits (1,V) fp32, caches), the caches updated in place."""
    h = params.embed[tokens]
    B, C, _ = h.shape
    positions = start + torch.arange(C, device=h.device).expand(B, C)
    for i, kind in enumerate(cfg.kinds()):
        h, _ = block_prefill_paged(kind, layer_params(params, cfg, i), h,
                                   positions, layer_cache(caches, cfg, i),
                                   cfg, knobs, slot=slot, mesh=mesh)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_fn(params, h[:, -1], cfg), caches


def prefill_with_cache(params, tokens, cfg: ModelConfig, max_len: int,
                       knobs: ApproxKnobs = PRECISE):
    """tokens: (B, S) -> (last-token logits (B,V) fp32, decode caches).

    One full-sequence forward (its attention through ``ops.flash``, its
    Mamba scans through ``ops.ssd`` with the final state out); the caches
    come back in the ``lm.init_caches`` layout with the last ``min(S, W)``
    positions of each ring filled and each Mamba layer's state and conv
    histories after token S - 1, and ``lm.decode_step`` continues from
    position S."""
    h = params.embed[tokens]
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    period = len(cfg.pattern)
    per_layer = []
    for i, kind in enumerate(cfg.kinds()):
        p = layer_params(params, cfg, i)
        if kind == MAMBA:
            h, cache = _mamba_block_with_state(p, h, cfg, knobs)
        else:
            h, cache = _attn_block_with_kv(p, h, positions, cfg, kind, knobs,
                                           max_len)
        per_layer.append(cache)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    caches = tuple(
        type(per_layer[j])(*(torch.stack(leaves) for leaves in
                             zip(*per_layer[j::period])))
        for j in range(period))
    return logits_fn(params, h[:, -1], cfg), caches
