"""Whisper-style encoder-decoder backbone. Counterpart of the JAX package's
``models/encdec.py``. The conv/mel frontend is a stub: the inputs are
precomputed (B, ``encoder_seq``, d_model) frame embeddings.

Parameters are a ``ParamTree`` with ``embed``, ``enc``: one ATTN block per
encoder layer, ``enc_norm``, ``dec``: one ATTN block with a cross sublayer
per decoder layer (the JAX package's ``dec.pos0``, stacked over the layer
groups), and ``final_norm``; the unembedding is ``embed.T``. The encoder's
self-attention is not causal. The decoder's cross attention runs over the
encoder's output, in the full forward and in the one-token decode step,
which recomputes the cross K/V from ``enc_out`` every step, as the JAX
package does; the decoder's self-attention decodes on the dense rings of
``lm.init_caches``.

As in the JAX package, ``remat`` "full", "2level" and "dots" all
checkpoint each encoder layer and each decoder layer whole.
"""
from __future__ import annotations

import torch

from repro_torch.approx.knobs import PRECISE, ApproxKnobs, keep_groups
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models.blocks import block_decode, block_forward, block_specs
from repro_torch.models.common import (ParamSpec, ParamTree, init_params,
                                       resolve_device, rms_norm)
from repro_torch.models.lm import (chunked_xent, init_caches, layer_cache,
                                   logits_fn, remat_loop)

__all__ = ["encdec_specs", "init_encdec", "encode", "decode_hidden",
           "encdec_loss", "encdec_decode_step", "init_caches"]


def encdec_specs(cfg: ModelConfig):
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed")),
        "enc": [block_specs(ATTN, cfg) for _ in range(cfg.n_encoder_layers)],
        "enc_norm": ParamSpec((d,), ("embed",), init="ones"),
        "dec": [block_specs(ATTN, cfg, cross=True)
                for _ in range(cfg.n_groups)],
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }


def init_encdec(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device="cuda") -> ParamTree:
    """Random weights from ``seed`` on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return ParamTree(init_params(encdec_specs(cfg), gen, dtype, device))


def _remat(remat: str) -> str:
    return "none" if remat == "none" else "full"


def encode(params, frames, cfg: ModelConfig, knobs: ApproxKnobs = PRECISE,
           *, remat: str = "full"):
    """frames: (B, F, D) stub embeddings -> (B, F, D) memory: the encoder's
    blocks without a causal mask, then ``enc_norm``."""
    h = frames.to(params.enc_norm.dtype)
    B, F = h.shape[:2]
    positions = torch.arange(F, device=h.device).expand(B, F)

    def body(h, item):
        return (block_forward(ATTN, params.enc[item], h, positions, cfg,
                              knobs, causal=False)[0],)

    (h,) = remat_loop(body, (h,), range(cfg.n_encoder_layers), _remat(remat))
    return rms_norm(h, params.enc_norm, cfg.norm_eps)


def decode_hidden(params, tokens, enc_out, cfg: ModelConfig,
                  knobs: ApproxKnobs = PRECISE, *, remat: str = "full"):
    """tokens: (B, S) -> (B, S, D) final-normed: the decoder's layers (those
    ``keep_groups`` keeps under ``layer_skip``) with cross attention over
    ``enc_out``."""
    h = params.embed[tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device).expand(B, S)

    def body(h, item):
        return (block_forward(ATTN, params.dec[item], h, positions, cfg,
                              knobs, enc_out=enc_out)[0],)

    (h,) = remat_loop(body, (h,), keep_groups(cfg.n_groups, knobs.layer_skip),
                      _remat(remat))
    return rms_norm(h, params.final_norm, cfg.norm_eps)


def encdec_loss(params, batch, cfg: ModelConfig,
                knobs: ApproxKnobs = PRECISE, *, remat: str = "full",
                ep_axis=None, mesh=None, aux_coef: float = 0.0):
    """batch: {"tokens": (B,S+1), "frames": (B,F,D)}. The ``token_drop``
    knob keeps the first ``b_keep`` rows of both. Returns (loss, metrics),
    the aux loss 0. ``ep_axis`` and ``mesh`` are taken as the JAX
    function takes them and reach nothing (no expert layers)."""
    tokens, frames = batch["tokens"], batch["frames"]
    if knobs.token_drop > 0:
        b_keep = max(1, int(tokens.shape[0] * (1.0 - knobs.token_drop)))
        tokens, frames = tokens[:b_keep], frames[:b_keep]
    enc_out = encode(params, frames, cfg, knobs, remat=remat)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h = decode_hidden(params, inputs, enc_out, cfg, knobs, remat=remat)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    loss = chunked_xent(params, h, labels, mask, cfg)
    return loss, {"ce": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=h.device)}


def encdec_decode_step(params, tokens, position, caches, enc_out,
                       cfg: ModelConfig, knobs: ApproxKnobs = PRECISE):
    """One-token decode: tokens (B,1) int, position (B,) int32, ``caches``
    the dense rings of ``init_caches``, ``enc_out`` (B,F,D). Returns
    (logits (B,V) fp32, caches), the caches updated in place."""
    h = params.embed[tokens[:, 0]][:, None, :]
    for i in range(cfg.n_groups):
        h, _ = block_decode(ATTN, params.dec[i], h, position,
                            layer_cache(caches, cfg, i), cfg, knobs,
                            enc_out=enc_out)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_fn(params, h[:, 0], cfg), caches
