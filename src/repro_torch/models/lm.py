"""Decoder-only LM: specs, init, logits; on the serving path the decode
caches and the one-token decode step, on the training path the
full-sequence forward, the chunked cross-entropy and ``lm_loss``.
Counterpart of the JAX package's ``models/lm.py``; a Python loop over the
layers takes the place of ``lax.scan`` over layer groups, and
``torch.utils.checkpoint`` the place of ``jax.checkpoint``.

On the serving path ``init_caches`` (dense rings) and
``init_paged_caches`` (the page pool) lay out the decode caches, and
``decode_step`` runs on either. ``sample_token`` and ``decode_megastep``
(paged) are the twins of the JAX package's on-device sampler and K-step
megastep: the sampler keys its temperature draws by threefry
(``models/threefry.py``), and the megastep's K steps are a Python loop over
one body that updates its carry and the caches in place (the engine
replays that body as a CUDA graph on the card).

Parameters are a ``ParamTree`` with ``embed``, ``final_norm`` (and
``unembed`` when untied), ``layers``: one block per layer in
``cfg.kinds()`` order (an empty one at a SHARED_ATTN position), and, for a
pattern with SHARED_ATTN (zamba2), ``shared``: the one attention block
every SHARED_ATTN layer runs (``layer_params``). Caches keep the JAX
layout: one ``KVCache``, ``PagedKVCache`` or ``MambaCache`` per pattern
position whose leaves are stacked over layer groups (axis 0; a ring's
cursor is a (n_groups,) tensor), and layer ``g * period + j`` works on
group ``g`` of cache ``j`` in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.approx.knobs import PRECISE, ApproxKnobs, keep_groups
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MAMBA, SHARED_ATTN,
                                      ModelConfig)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.blocks import block_decode, block_forward, block_specs
from repro_torch.models import threefry
from repro_torch.models.common import (ParamSpec, ParamTree, init_params,
                                       resolve_device, rms_norm, softcap)


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The model's ``ParamSpec`` tree. A config with experts raises: the
    port has no MoE block, and a dense stand-in would be another model."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported (ROADMAP.md queue 1, "
            f"item 5 'MoE'); the port only prices this config")
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed")),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    specs["layers"] = [{} if kind == SHARED_ATTN else block_specs(kind, cfg)
                       for kind in cfg.kinds()]
    if SHARED_ATTN in cfg.pattern:
        specs["shared"] = block_specs(ATTN, cfg)
    return specs


def layer_params(params, cfg: ModelConfig, i: int):
    """Layer ``i``'s block: the shared block at a SHARED_ATTN position."""
    if cfg.pattern[i % len(cfg.pattern)] == SHARED_ATTN:
        return params.shared
    return params.layers[i]


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


# ---------------------------------------------------------------- training --

def forward_hidden(params, tokens, cfg: ModelConfig,
                   knobs: ApproxKnobs = PRECISE, *, remat: str = "full"):
    """tokens: (B, S) -> (h (B,S,D) final-normed, aux loss). Every block
    sees the positions ``arange(S)``.

    The ``layer_skip`` knob runs only ``keep_groups``' layer groups.
    ``remat``: "none" keeps every activation; "full" recomputes each layer
    group in the backward (``torch.utils.checkpoint`` per group)."""
    if remat not in ("none", "full"):
        raise ValueError(f"forward_hidden: remat must be none | full, "
                         f"got {remat!r}")
    h = params.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    period = len(cfg.pattern)

    def group_body(h, aux, g):
        for j, kind in enumerate(cfg.pattern):
            h, a = block_forward(kind,
                                 layer_params(params, cfg, g * period + j),
                                 h, positions, cfg, knobs)
            aux = aux + a
        return h, aux

    for g in keep_groups(cfg.n_groups, knobs.layer_skip):
        if remat == "full":
            h, aux = checkpoint(group_body, h, aux, g, use_reentrant=False)
        else:
            h, aux = group_body(h, aux, g)
    return rms_norm(h, params.final_norm, cfg.norm_eps), aux


def ce_chunk(s: int, target: int = 512) -> int:
    """Largest divisor of ``s`` that is <= target (CE chunk length)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _xent_chunk(hc, lc, mc, emb, cap):
    logits = softcap((hc @ emb).float(), cap)
    m = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def chunked_xent(params, h, labels, mask, cfg: ModelConfig, *,
                 chunk: int = 512):
    """Mean next-token CE without materialising the (B,S,V) logits: each
    sequence chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``). h: (B,S,D); labels: (B,S) (already
    shifted); mask: (B,S) float weights."""
    S = h.shape[1]
    C = ce_chunk(S, chunk)
    emb = _unembed(params)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, C):
        sl = slice(s0, s0 + C)
        l, w = checkpoint(_xent_chunk, h[:, sl], labels[:, sl], mask[:, sl],
                          emb, cfg.final_softcap, use_reentrant=False)
        loss_sum = loss_sum + l
        w_sum = w_sum + w
    return loss_sum / torch.clamp(w_sum, min=1.0)


def lm_loss(params, batch, cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
            remat: str = "full", aux_coef: float = 0.01):
    """batch: {"tokens": (B,S+1) int}. The ``token_drop`` knob (batch
    perforation) keeps the first ``b_keep`` rows. Returns (loss, metrics)."""
    tokens = batch["tokens"]
    if knobs.token_drop > 0:
        b_keep = max(1, int(tokens.shape[0] * (1.0 - knobs.token_drop)))
        tokens = tokens[:b_keep]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, aux = forward_hidden(params, inputs, cfg, knobs, remat=remat)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    loss = chunked_xent(params, h, labels, mask, cfg)
    return loss + aux_coef * aux, {"ce": loss, "aux": aux}


# ------------------------------------------------------------------ decode --

def _stack_groups(cache, cfg: ModelConfig):
    """One layer's cache repeated over the layer groups (axis 0)."""
    return type(cache)(*(x[None].repeat((cfg.n_groups,) + (1,) * x.ndim)
                         for x in cache))


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, quantized: bool = False, device="cpu"):
    """One dense ``KVCache`` (a ``MambaCache`` at a MAMBA position) per
    pattern position, stacked over the layer groups: a local layer's ring
    is ``min(window, max_len)`` wide, a global layer's ``max_len``."""
    def one(kind):
        if kind == MAMBA:
            return _stack_groups(mamba_mod.init_mamba_cache(
                cfg, batch, dtype, device=device), cfg)
        length = min(cfg.window, max_len) if kind == LOCAL_ATTN else max_len
        return _stack_groups(attn_mod.init_cache(
            cfg, batch, length, dtype, quantized=quantized, device=device),
            cfg)
    return tuple(one(kind) for kind in cfg.pattern)


def init_paged_caches(cfg: ModelConfig, batch: int, n_pages: int,
                      page_size: int, max_pages: int, dtype=torch.bfloat16,
                      quantized: bool = False, device="cpu"):
    """One ``PagedKVCache`` per attention position of the pattern, every
    leaf stacked over the layer groups (the block table is replicated per
    group, as in the JAX package); a MAMBA position keeps one
    ``MambaCache`` row per slot."""
    def one(kind):
        if kind == MAMBA:
            return _stack_groups(mamba_mod.init_mamba_cache(
                cfg, batch, dtype, device=device), cfg)
        return _stack_groups(attn_mod.init_paged_cache(
            cfg, batch, n_pages, page_size, max_pages, dtype,
            quantized=quantized, device=device), cfg)
    return tuple(one(kind) for kind in cfg.pattern)


def layer_cache(caches, cfg: ModelConfig, layer: int):
    """Views of layer ``layer``'s cache, of its stacked cache's type
    (writes land in ``caches``)."""
    g, j = divmod(layer, len(cfg.pattern))
    return type(caches[j])(*(x[g] for x in caches[j]))


def decode_step(params, tokens, position, caches, cfg: ModelConfig,
                knobs: ApproxKnobs = PRECISE, *, active=None):
    """tokens: (B,1) int; position: (B,) int32 absolute positions.

    Returns (logits (B,V) fp32, caches), the caches updated in place.
    ``caches`` are dense rings (``init_caches``) or the page pool
    (``init_paged_caches``); on the pool ``active`` (B,) bool masks
    per-slot cache writes (attention pages and Mamba rows)."""
    h = params.embed[tokens[:, 0]][:, None, :]
    for i, kind in enumerate(cfg.kinds()):
        h, _ = block_decode(kind, layer_params(params, cfg, i), h, position,
                            layer_cache(caches, cfg, i), cfg, knobs,
                            active=active)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    return logits_fn(params, h[:, 0], cfg), caches


def sample_token(logits, uids, draws, *, temperature: float = 0.0,
                 seed: int = 0):
    """On-device sampler under the ``(seed, uid, draw_index)`` contract.

    logits: (B, V) fp32; uids/draws: (B,) int. Greedy argmax when
    ``temperature <= 0``; otherwise the Gumbel-max categorical draw of
    ``logits / temperature`` keyed by ``fold_in(fold_in(PRNGKey(seed),
    uid), draw)``, the JAX package's bits. The key depends only on the
    request and how many tokens it has emitted, not on the batch slot, the
    megastep width or the dispatch grouping; it is made from the device
    tensors with no generator state, so the sampler can be captured in a
    graph. Returns (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    base = threefry.prng_key(seed, logits.device)
    keys = threefry.fold_in(threefry.fold_in(base, uids), draws)
    return threefry.categorical(keys, logits / temperature).to(torch.int32)


def decode_megastep(params, cur, pos, alive, uids, draws, budget, caches,
                    cfg: ModelConfig, knobs: ApproxKnobs = PRECISE, *,
                    k: int, temperature: float = 0.0, seed: int = 0,
                    eos_id: int = -1):
    """K fused decode steps with on-device sampling and stop masking; the
    host learns K tokens a row from one transfer.

    cur: (B,) int32 current tokens (the token whose KV is written at
    ``pos``); pos: (B,) int32 absolute positions; alive: (B,) bool live
    rows (also ``decode_step``'s cache-write ``active``); uids/draws: (B,)
    int32 sampler-stream coordinates; budget: (B,) int32 tokens each row
    may still emit.

    Each step a live row writes KV at ``pos``, samples the next token and
    advances; a dead row is frozen (its carry untouched, its output the -1
    sentinel; vocab ids are >= 0). Rows die on EOS (``eos_id >= 0``) or
    when their budget runs out, so an EOS mid-megastep stops that row's
    cache writes at once. A fully live row writes KV at positions up to
    ``pos + k - 1``; the host maps those pages before the call
    (``PagePool.ensure_decode_range``).

    The carry (cur, pos, alive, draws, budget) and the caches are updated
    in place. Returns ``(toks (B, K) int32, cur, pos, alive, draws,
    budget, caches)``."""
    toks = []
    for _ in range(k):
        logits, caches = decode_step(params, cur.long()[:, None], pos, caches,
                                     cfg, knobs, active=alive)
        tok = sample_token(logits, uids, draws, temperature=temperature,
                           seed=seed)
        out = torch.where(alive, tok, -1)
        step1 = alive.to(torch.int32)
        cur.copy_(torch.where(alive, tok, cur))
        draws.add_(step1)
        budget.sub_(step1)
        pos.add_(step1)
        live = alive & (budget > 0)
        if eos_id >= 0:
            live &= out != eos_id
        alive.copy_(live)
        toks.append(out)
    return torch.stack(toks, dim=1), cur, pos, alive, draws, budget, caches
