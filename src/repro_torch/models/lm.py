"""Decoder-only LM on the paged serving path: specs, init, logits, paged
caches and the one-token decode step. Counterpart of the JAX package's
``models/lm.py``; a Python loop over the layers takes the place of
``lax.scan`` over layer groups.

Parameters are a ``ParamTree`` with ``embed``, ``final_norm`` (and
``unembed`` when untied) and ``layers``: one block per layer in
``cfg.kinds()`` order. Caches keep the JAX layout: one ``PagedKVCache`` per
pattern position whose leaves are stacked over layer groups (axis 0), and
layer ``g * period + j`` works on group ``g`` of cache ``j`` in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.blocks import block_decode, block_specs
from repro_torch.models.common import (ParamSpec, ParamTree, init_params,
                                       resolve_device, rms_norm, softcap)


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    specs["layers"] = [block_specs(kind, cfg) for kind in cfg.kinds()]
    return specs


def init_lm(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
            device="cuda") -> ParamTree:
    """Random weights from ``seed`` on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return ParamTree(init_params(lm_specs(cfg), gen, dtype, device))


def _unembed(params):
    if hasattr(params, "unembed"):
        return params.unembed
    return params.embed.T


def logits_fn(params, h, cfg: ModelConfig):
    """h: (..., D) -> (..., V) fp32, softcapped."""
    logits = (h @ _unembed(params)).float()
    return softcap(logits, cfg.final_softcap)


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, max_pages: int, dtype=torch.bfloat16,
                      quantized: bool = False, device="cpu"):
    """One ``PagedKVCache`` per pattern position, every leaf stacked over
    the layer groups (the block table is replicated per group, as in the
    JAX package)."""
    def one():
        c = attn_mod.init_paged_cache(cfg, batch, n_pages, page_size,
                                      max_pages, dtype, quantized=quantized,
                                      device=device)
        return attn_mod.PagedKVCache(*(
            x[None].repeat((cfg.n_groups,) + (1,) * x.ndim) for x in c))
    return tuple(one() for _ in cfg.pattern)


def layer_cache(caches, cfg: ModelConfig, layer: int):
    """Views of layer ``layer``'s cache (writes land in ``caches``)."""
    g, j = divmod(layer, len(cfg.pattern))
    return attn_mod.PagedKVCache(*(x[g] for x in caches[j]))


def decode_step(params, tokens, position, caches, cfg: ModelConfig,
                knobs: ApproxKnobs = PRECISE, *, active=None):
    """tokens: (B,1) int; position: (B,) int32 absolute positions.

    Returns (logits (B,V) fp32, caches), the caches updated in place.
    ``active`` (B,) bool masks per-slot cache writes."""
    h = params.embed[tokens[:, 0]][:, None, :]
    for i, kind in enumerate(cfg.kinds()):
        h, _ = block_decode(kind, params.layers[i], h, position,
                            layer_cache(caches, cfg, i), cfg, knobs,
                            active=active)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_fn(params, h[:, 0], cfg), caches
