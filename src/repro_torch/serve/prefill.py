"""Chunked-prefill admission into the paged pool. Counterpart of the JAX
package's ``serve/prefill.paged_prefill_chunk``."""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import block_prefill_paged
from repro_torch.models.common import rms_norm
from repro_torch.models.lm import layer_cache, logits_fn


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
        h, _ = block_prefill_paged(kind, params.layers[i], h, positions,
                                   layer_cache(caches, cfg, i), cfg, knobs,
                                   slot=slot, mesh=mesh)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_fn(params, h[:, -1], cfg), caches
