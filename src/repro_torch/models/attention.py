"""GQA attention: specs, the fp32-softmax core, the full-sequence
(training) forward, int8 KV encoding, the dense ring cache and the paged
cache, one-token decode and chunked prefill on each.

Counterpart of the JAX package's ``models/attention.py``, single device.
The full-sequence forward goes through ``ops.flash`` (the CUDA
``flash_attention`` kernel on the card, its plain version on the CPU) in
every mode but the perforated causal one: with ``kv_keep_stride`` > 1 it is
``_causal_chunked``, the JAX package's absolute perforation rule, in plain
PyTorch.

Dense rings (``KVCache``): decode and chunked prefill write their K/V at
``cursor``-relative ring slots with index writes (the slots of the JAX
package's one-hot selects, the same values bit for bit) and attend with
``_sdpa`` over the ring, as the JAX package does outside any Pallas
kernel; under a mesh whose plan carries a sequence ring, a chunk attends
with ``ring_chunk_attention`` over ``[ring; chunk]`` (the ``ring_hop``
kernel). The cursor stays a device tensor, so a decode step needs no host
sync.

Paged pool (``PagedKVCache``): decode writes the new K/V entry with a plain
index write and then calls the fused ``paged_attention`` kernel; under a
mesh whose ``paged_decode_plan`` finds a slot-affinity layout, the write
and the kernel run once per shard over the shard's rows and its own page
range (``paged_attention_sharded``), and under a mesh without a plan,
decode takes the ``_gather_pages`` + ``_sdpa`` path, loudly
(``DISPATCH_COUNTS`` counts each path a layer call). The engine derives
the plan and passes its shard count down. Chunked prefill
gathers the slot's pages and runs ``_sdpa``, as the JAX package does, or,
under a mesh whose plan carries a sequence ring, ``ring_chunk_attention``
over the gathered block row.

Cache writes update the cache tensors in place.
"""
from __future__ import annotations

import collections
import sys
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import implied
from repro_torch.dist.sharding import paged_decode_plan, prefill_plan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa_mod
from repro_torch.kernels.ring_attention import ring_chunk_attention
from repro_torch.models.common import ParamSpec, apply_rope, softcap


def attn_specs(cfg: ModelConfig):
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "wq": ParamSpec((d, q), ("embed", "q_heads")),
        "wk": ParamSpec((d, kv), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kv), ("embed", "kv_heads")),
        "wo": ParamSpec((q, d), ("q_heads", "embed")),
    }


def _split_heads(x, n_heads, head_dim):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _sdpa(q, k, v, *, mask=None, cap: float = 0.0):
    """q: (B,Sq,G,R,hd) k/v: (B,Skv,G,hd). Scores and softmax in fp32, the
    masked entries at -1e30, ``p`` cast to q's dtype before P.V."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsgrh,btgh->bgrst", q.float(), k.float()) * scale
    s = softcap(s, cap) if cap else s
    if mask is not None:
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrst,btgh->bsgrh", p, v)


def default_q_chunk(seq_len: int) -> int:
    """The JAX package's query chunk of ``_causal_chunked``: 1024 up to
    8192 tokens, 256 beyond (bounds the fp32 score tile)."""
    if seq_len <= 8192:
        return 1024
    return 256


def attention(params, x, positions, cfg: ModelConfig, *,
              mode: str = "causal",          # causal | window | cross | full
              kv_x=None, q_chunk: int = 0, kv_keep_stride: int = 1,
              rope: bool = True):
    """Full-sequence attention. x: (B,S,D); positions: (B,S). Returns
    (B,S,D).

    ``causal`` (at ``kv_keep_stride`` <= 1), ``window`` (causal within
    ``cfg.window``, the mask of the JAX package's ``_banded``) and
    ``full``/``cross`` (no mask; ``cross`` attends over ``kv_x`` without
    RoPE) go through ``ops.flash``. ``causal`` at ``kv_keep_stride`` > 1 is
    ``_causal_chunked``: the kernel's own stride rule is relative to the
    query block and keeps other blocks, so the model path does not use it."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    G, R = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ params.wq, cfg.n_heads, hd)
    k = _split_heads(src @ params.wk, G, hd)
    v = _split_heads(src @ params.wv, G, hd)
    if rope and mode != "cross":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "causal" and kv_keep_stride > 1:
        o = _causal_chunked(q.reshape(B, S, G, R, hd), k, v,
                            q_chunk=q_chunk or default_q_chunk(S),
                            kv_keep_stride=kv_keep_stride,
                            cap=cfg.attn_softcap)
    else:
        o = kops.flash(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=mode in ("causal", "window"),
                       window=cfg.window if mode == "window" else 0,
                       cap=cfg.attn_softcap).transpose(1, 2)
    return o.reshape(B, S, cfg.q_dim) @ params.wo


def _causal_chunked(q, k, v, *, q_chunk: int, kv_keep_stride: int,
                    cap: float):
    """Query chunk i of C rows sees the keys of chunks 0..i, masked
    causally; with ``kv_keep_stride=p`` > 1 the off-diagonal chunks are
    perforated: chunk i keeps chunks i-1 and i and every old chunk j with
    ``j % p == 0``. q: (B,S,G,R,hd); k/v: (B,S,G,hd)."""
    S = q.shape[1]
    C = min(q_chunk, S)
    assert S % C == 0, (S, C)
    dev = q.device
    outs = []
    for i in range(S // C):
        if kv_keep_stride <= 1 or i <= 1:
            keep = list(range(i + 1))
        else:
            keep = [j for j in range(i - 1) if j % kv_keep_stride == 0] \
                + [i - 1, i]
        ki = torch.cat([k[:, j * C:(j + 1) * C] for j in keep], dim=1)
        vi = torch.cat([v[:, j * C:(j + 1) * C] for j in keep], dim=1)
        kv_pos = torch.cat([torch.arange(j * C, (j + 1) * C, device=dev)
                            for j in keep])
        q_pos = torch.arange(i * C, (i + 1) * C, device=dev)
        mask = kv_pos[None, :] <= q_pos[:, None]              # (C, Skv_i)
        outs.append(_sdpa(q[:, i * C:(i + 1) * C], ki, vi,
                          mask=mask[None, None, None], cap=cap))
    return torch.cat(outs, dim=1)


# Global static scale of the int8-quantized serving KV cache (the
# ``kv_quant`` knob), shared by decode, chunked prefill and the engine's
# cache conversion on a variant hot-swap.
KV_SCALE = 0.05


def quantize_kv(x, scale: float = KV_SCALE):
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def dequantize_kv(x, dtype, scale: float = KV_SCALE):
    return x.to(dtype) * scale


class KVCache(NamedTuple):
    """Dense decode cache of one layer: a ring of ``W`` entries per batch
    row (a local layer's ring is its window, a global layer's ``max_len``),
    written at ``cursor % W``. The cursor is shared by every row."""
    k: torch.Tensor       # (B, W, G, hd)
    v: torch.Tensor
    pos: torch.Tensor     # (B, W) int32 absolute positions, -1 = empty
    cursor: torch.Tensor  # () int32: the next write slot (mod W)


def init_cache(cfg: ModelConfig, batch: int, length: int,
               dtype=torch.bfloat16, quantized: bool = False,
               device="cpu") -> KVCache:
    hd = cfg.resolved_head_dim
    kdt = torch.int8 if quantized else dtype
    shape = (batch, length, cfg.n_kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=kdt, device=device),
        v=torch.zeros(shape, dtype=kdt, device=device),
        pos=torch.full((batch, length), -1, dtype=torch.int32,
                       device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device))


class PagedKVCache(NamedTuple):
    """Paged decode cache: entries live in a shared physical page pool and
    each batch slot maps logical pages (position // page_size) to physical
    pages through its block-table row. Physical page 0 is the reserved
    null page: unmapped block entries point at it and are masked out of
    attention, and inactive decode rows write into it harmlessly."""
    kp: torch.Tensor      # (n_pages, page_size, G, hd) physical page pool
    vp: torch.Tensor
    ppos: torch.Tensor    # (n_pages, page_size) int32 positions, -1 empty
    block: torch.Tensor   # (B, max_pages) int32 physical page ids, 0 = unmapped


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int,
                     page_size: int, max_pages: int, dtype=torch.bfloat16,
                     quantized: bool = False, device="cpu") -> PagedKVCache:
    hd = cfg.resolved_head_dim
    kdt = torch.int8 if quantized else dtype
    shape = (n_pages, page_size, cfg.n_kv_heads, hd)
    return PagedKVCache(
        kp=torch.zeros(shape, dtype=kdt, device=device),
        vp=torch.zeros(shape, dtype=kdt, device=device),
        ppos=torch.full((n_pages, page_size), -1, dtype=torch.int32,
                        device=device),
        block=torch.zeros((batch, max_pages), dtype=torch.int32,
                          device=device))


def _gather_pages(cache: PagedKVCache, block, q_positions, *, window: int):
    """Gather a block table's pages into contiguous K/V + validity mask.

    block: (B, M); q_positions: (B, C) absolute query positions. Returns
    (k (B, M*P, G, hd), v, pos (B, M*P), valid (B, C, M*P)). Unmapped
    entries (physical page 0) are masked regardless of its contents."""
    n_pages, P = cache.ppos.shape
    B, M = block.shape
    idx = block.long()
    gk = cache.kp[idx].reshape(B, M * P, *cache.kp.shape[2:])
    gv = cache.vp[idx].reshape(B, M * P, *cache.vp.shape[2:])
    gpos = cache.ppos[idx].reshape(B, M * P)
    mapped = (block != 0).repeat_interleave(P, dim=1)          # (B, M*P)
    valid = (mapped[:, None, :] & (gpos[:, None, :] >= 0)
             & (gpos[:, None, :] <= q_positions[:, :, None]))
    if window:
        valid &= gpos[:, None, :] > q_positions[:, :, None] - window
    return gk, gv, gpos, valid


def _qkv(params, x, positions, cfg: ModelConfig, kv_scale: float, kv_dtype):
    """Projected, RoPE'd q (B,S,H,hd) and the K/V entries to store."""
    hd = cfg.resolved_head_dim
    G = cfg.n_kv_heads
    q = _split_heads(x @ params.wq, cfg.n_heads, hd)
    k = _split_heads(x @ params.wk, G, hd)
    v = _split_heads(x @ params.wv, G, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_scale:
        return q, quantize_kv(k, kv_scale), quantize_kv(v, kv_scale)
    return q, k.to(kv_dtype), v.to(kv_dtype)


def _as_q(a, dtype, kv_scale: float):
    """Stored K/V entries at the queries' dtype (dequantised when int8)."""
    return dequantize_kv(a, dtype, kv_scale) if kv_scale else a.to(dtype)


def decode_attention(params, x, position, cache: KVCache, cfg: ModelConfig,
                     *, window: int = 0, kv_scale: float = 0.0):
    """One-token decode against a dense ring. x: (B,1,D); position: (B,)
    absolute positions.

    Every row writes its new K/V entry at ring slot ``cursor % W`` (an
    index write at a device index), the cursor advances, and ``_sdpa``
    attends over the whole ring, the entries masked by position (valid,
    not ahead of the query, inside ``window`` when given). ``kv_scale`` > 0
    stores int8 entries. Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    G, R = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k_store, v_store = _qkv(params, x, position[:, None], cfg, kv_scale,
                               cache.k.dtype)
    W = cache.k.shape[1]
    slot = (cache.cursor.long() % W).reshape(1)
    cache.k.index_copy_(1, slot, k_store)
    cache.v.index_copy_(1, slot, v_store)
    cache.pos.index_copy_(1, slot, position.to(torch.int32)[:, None])
    cache.cursor.add_(1)
    kk = _as_q(cache.k, q.dtype, kv_scale)
    vv = _as_q(cache.v, q.dtype, kv_scale)
    npos, qpos = cache.pos, position[:, None]
    valid = (npos >= 0) & (npos <= qpos)
    if window:
        valid &= npos > qpos - window
    o = _sdpa(q.reshape(B, 1, G, R, hd), kk, vv,
              mask=valid[:, None, None, None, :], cap=cfg.attn_softcap)
    implied.seq_combine(B, G * R, hd)   # over a sequence-sharded cache
    return o.reshape(B, 1, cfg.q_dim) @ params.wo, cache


def chunk_decode_attention(params, x, positions, cache: KVCache,
                           cfg: ModelConfig, *, window: int = 0,
                           kv_scale: float = 0.0, mesh=None):
    """C-token prompt-chunk step against a dense ring (chunked admission).
    x: (B,C,D); positions: (B,C) absolute.

    The chunk attends over ``[ring entries; the chunk]``, causally by
    position and inside ``window`` when given, so its own tokens are
    visible even when C exceeds the ring. Then its last ``min(C, W)``
    entries go into the ring at ``(cursor + C - n_keep + j) % W``, the
    slots C successive decode steps would have written, and the cursor
    advances by C: decode continues from it as from a token-by-token
    warmup. Under a ``mesh`` whose ``prefill_plan`` finds a sequence layout
    for C, the attend is ``ring_chunk_attention`` over ``[ring; chunk]`` at
    storage dtype. Returns (out (B,C,D), cache)."""
    B, C, _ = x.shape
    hd = cfg.resolved_head_dim
    G, R = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k_store, v_store = _qkv(params, x, positions, cfg, kv_scale,
                               cache.k.dtype)
    qg = q.reshape(B, C, G, R, hd)
    pos32 = positions.to(torch.int32)
    kv_pos = torch.cat([cache.pos, pos32], dim=1)              # (B, W+C)
    plan, _ = _prefill_ring_plan(cfg, mesh, C)
    if plan is not None:
        o = ring_chunk_attention(
            qg, torch.cat([cache.k, k_store], dim=1),
            torch.cat([cache.v, v_store], dim=1), positions, kv_pos,
            mesh=mesh, plan=plan, window=window, cap=cfg.attn_softcap,
            kv_scale=kv_scale)
    else:
        kk = torch.cat([_as_q(cache.k, q.dtype, kv_scale),
                        _as_q(k_store, q.dtype, kv_scale)], dim=1)
        vv = torch.cat([_as_q(cache.v, q.dtype, kv_scale),
                        _as_q(v_store, q.dtype, kv_scale)], dim=1)
        kp, qp = kv_pos[:, None, :], positions[:, :, None]
        valid = (kp >= 0) & (kp <= qp)
        if window:
            valid &= kp > qp - window
        o = _sdpa(qg, kk, vv, mask=valid[:, None, None],
                  cap=cfg.attn_softcap)
    # the ring write, after the attend has copied the ring it read
    W = cache.k.shape[1]
    n_keep = min(C, W)
    dest = (cache.cursor.long() + (C - n_keep)
            + torch.arange(n_keep, device=x.device)) % W
    cache.k.index_copy_(1, dest, k_store[:, C - n_keep:])
    cache.v.index_copy_(1, dest, v_store[:, C - n_keep:])
    cache.pos.index_copy_(1, dest, pos32[:, C - n_keep:])
    cache.cursor.add_(C)
    return o.reshape(B, C, cfg.q_dim) @ params.wo, cache


# Which paged-decode path each layer call took: kernel_sharded (one launch
# per slot-affinity shard), gather_mesh (the gather fallback under a mesh
# with no plan), kernel_single. The gather fallback under a mesh is
# otherwise invisible from outside.
DISPATCH_COUNTS: "collections.Counter[str]" = collections.Counter()

_GATHER_WARNED: set = set()


def _warn_gather(reason: str) -> None:
    """One line per distinct reason: a mesh silently paying O(slots x
    max_len) gather traffic is the regression class the sharded path
    replaces."""
    if reason in _GATHER_WARNED:
        return
    _GATHER_WARNED.add(reason)
    print("repro_torch: paged decode under a mesh is taking the dense "
          f"gather path — {reason}; the fused kernel is not sharded, so "
          "decode traffic is O(slots x max_len)", file=sys.stderr)


def explain_dispatch(cfg: ModelConfig, mesh, *, batch_slots: int,
                     n_pages: int = 0, megastep_k: int = 0,
                     device="cpu") -> str:
    """One-line description of the paged-decode path this configuration
    dispatches to (``launch/serve.py``'s startup banner): the kernel is
    the CUDA kernel on the card, its plain version on the CPU;
    ``megastep_k`` > 0 notes the fused K-token megastep."""
    kern = ("fused CUDA paged_attention kernel"
            if torch.device(device).type in ("cuda", "meta")
            else "paged_attention's plain PyTorch version")
    mega = (f", inside a fused {megastep_k}-token megastep"
            if megastep_k > 0 else "")
    if mesh is None:
        return f"paged decode: {kern}, single device{mega}"
    plan, reason = paged_decode_plan(cfg, mesh, batch_slots, n_pages)
    if plan is not None:
        heads = (f"kv_heads over {plan.kv_head_axis!r} in the plan, all "
                 "heads computed per shard" if plan.kv_head_axis
                 else "kv_heads replicated")
        return (f"paged decode: {kern}, one launch per shard over "
                f"{plan.batch_axes!r} ({plan.n_shards} slot-affinity shards "
                f"run in turn on {mesh.device}, {heads}){mega}")
    return ("paged decode: dense gather FALLBACK under mesh — "
            f"{reason}{mega}")


def paged_decode_attention(params, x, position, cache: PagedKVCache,
                           cfg: ModelConfig, *, window: int = 0,
                           kv_scale: float = 0.0, active=None, shards=1):
    """One-token decode against the paged pool. x: (B,1,D); position: (B,).

    The new K/V entry is written in place into the slot's tail page with an
    index write; rows with ``active`` False are redirected to a null page,
    which is never read (the FREEZE contract: their pages stay
    bit-identical). Then the fused ``paged_attention`` kernel reads every
    mapped page through the block table.

    ``shards`` is the caller's decode plan (the engine derives it from its
    mesh): 1, one kernel launch over the whole pool; n > 1, the JAX
    package's ``_sharded_write_attend`` over a slot-affinity pool of n
    shards: every row's target page lies in its shard's page range (an
    inactive row's is its shard's null page), and the attend is one launch
    a shard over the shard's rows and page range
    (``paged_attention_sharded``: views, the block table rebased to local
    ids, the whole pool's page split, so bit-equal to one launch); None,
    a mesh with no plan: the ``_gather_pages`` + ``_sdpa`` reference.
    Returns (out (B,1,D), cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    G, R = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k_store, v_store = _qkv(params, x, position[:, None], cfg, kv_scale,
                               cache.kp.dtype)
    n_pages, P = cache.ppos.shape
    DISPATCH_COUNTS["gather_mesh" if shards is None else
                    "kernel_single" if shards == 1 else "kernel_sharded"] += 1
    pos = position.long()
    pos32 = position.to(torch.int32).contiguous()
    tgt = torch.gather(cache.block, 1, (pos // P)[:, None])[:, 0].long()
    if active is not None:
        null = 0 if not shards or shards == 1 else \
            torch.arange(B, device=x.device) // (B // shards) \
            * (n_pages // shards)
        tgt = torch.where(active, tgt, null)
    off = pos % P
    cache.kp[tgt, off] = k_store[:, 0]
    cache.vp[tgt, off] = v_store[:, 0]
    cache.ppos[tgt, off] = pos32
    qk = q[:, 0].reshape(B, G, R, hd).contiguous()
    kw = dict(window=window, kv_scale=kv_scale, cap=cfg.attn_softcap)
    if shards is None:
        kk, vv, _, valid = _gather_pages(cache, cache.block,
                                         position[:, None], window=window)
        o = _sdpa(q.reshape(B, 1, G, R, hd), _as_q(kk, q.dtype, kv_scale),
                  _as_q(vv, q.dtype, kv_scale), mask=valid[:, None, None],
                  cap=cfg.attn_softcap)
    elif shards == 1:
        o = kops.paged_attention(qk, cache.kp, cache.vp, cache.ppos,
                                 cache.block, pos32, **kw)
    else:
        o = pa_mod.paged_attention_sharded(qk, cache.kp, cache.vp, cache.ppos,
                                           cache.block, pos32, shards, **kw)
    return o.reshape(B, 1, cfg.q_dim) @ params.wo, cache


# admission chunk attentions under a mesh that took the single-device path
# (the chunk is shorter than the ring's shard count); counted per layer
mesh_fallbacks = 0
_PREFILL_WARNED: set = set()


def _warn_prefill(reason: str) -> None:
    """Say once per reason, loudly, that an admission chunk under a mesh
    runs its attention whole on one device (no sequence ring)."""
    if reason in _PREFILL_WARNED:
        return
    _PREFILL_WARNED.add(reason)
    print("repro_torch: chunked-prefill admission under a mesh is taking the "
          f"single-device path — {reason}; the chunk's attention runs whole "
          "(no sequence ring)", file=sys.stderr)


def _prefill_ring_plan(cfg: ModelConfig, mesh, chunk_len: int):
    """The (plan, reason) a chunk cell dispatches on: the ring when
    ``prefill_plan`` finds a sequence layout for this chunk length, else
    the single-device path, counted in ``mesh_fallbacks`` and warned once
    when a mesh was given."""
    global mesh_fallbacks
    if mesh is None:
        return None, "no mesh (single device)"
    plan, reason = prefill_plan(cfg, mesh, chunk_len)
    if plan is None:
        mesh_fallbacks += 1
        _warn_prefill(reason)
    return plan, reason


def explain_prefill_dispatch(cfg: ModelConfig, mesh, *,
                             chunk_len: int) -> str:
    """One-line description of the chunked-prefill admission path this
    configuration dispatches to (``launch/serve.py``'s startup banner)."""
    if mesh is None:
        return "chunked prefill: whole-chunk admission cell, single device"
    plan, reason = prefill_plan(cfg, mesh, chunk_len)
    if plan is not None:
        heads = (f"kv_heads over {plan.kv_head_axis!r} in the plan, all "
                 "heads computed per shard" if plan.kv_head_axis
                 else "kv_heads replicated")
        hop = ("the ring_hop kernel" if mesh.device.type in ("cuda", "meta")
               else "ring_hop's plain version")
        return (f"chunked prefill: ring attention over {plan.seq_axis!r} "
                f"({plan.n_shards} sequence shards run in turn on "
                f"{mesh.device} through {hop}, {heads})")
    return ("chunked prefill: single-device admission FALLBACK under mesh — "
            f"{reason}")


def ring_attend(q, cache: PagedKVCache, brow, positions, *, mesh, plan,
                window: int = 0, cap: float = 0.0, kv_scale: float = 0.0):
    """The ring branch of the chunk cell: one slot's whole block row
    ``brow`` (M,) gathered from the pool, unmapped entries folded into the
    position lane as -1, then ``ring_chunk_attention``. q: (1, C, G, R, hd)
    at the chunk's ``positions`` (1, C). Returns (1, C, G, R, hd)."""
    P = cache.ppos.shape[1]
    idx = brow.long()
    L = idx.shape[0] * P
    gk = cache.kp[idx].reshape(1, L, *cache.kp.shape[2:])
    gv = cache.vp[idx].reshape(1, L, *cache.vp.shape[2:])
    mapped = (brow != 0).repeat_interleave(P)[None]
    kv_pos = torch.where(mapped, cache.ppos[idx].reshape(1, L), -1)
    return ring_chunk_attention(q, gk, gv, positions, kv_pos, mesh=mesh,
                                plan=plan, window=window, cap=cap,
                                kv_scale=kv_scale)


def paged_chunk_attention(params, x, positions, cache: PagedKVCache,
                          cfg: ModelConfig, slot: int, *, window: int = 0,
                          kv_scale: float = 0.0, mesh=None):
    """C-token prompt-chunk step for ONE slot of the paged pool (chunked
    admission). x: (1,C,D); positions: (1,C). Writes the chunk's K/V into
    the slot's (pre-allocated, private) pages in place, then attends over
    every mapped page, the chunk's own entries included, causally masked by
    position: the gather + ``_sdpa`` of the JAX package.

    Under a ``mesh`` whose ``prefill_plan`` finds a sequence layout for C,
    the attend is ``ring_chunk_attention`` over the slot's whole gathered
    block row instead, unmapped block entries folded into the position lane
    as -1 (masked as ``_gather_pages`` masks them)."""
    B, C, _ = x.shape
    hd = cfg.resolved_head_dim
    G, R = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k_store, v_store = _qkv(params, x, positions, cfg, kv_scale,
                               cache.kp.dtype)
    P = cache.ppos.shape[1]
    brow = cache.block[slot]                              # (M,)
    pos_c = positions[0].long()                           # (C,)
    phys = brow[pos_c // P].long()
    off = pos_c % P
    cache.kp[phys, off] = k_store[0]
    cache.vp[phys, off] = v_store[0]
    cache.ppos[phys, off] = positions[0].to(torch.int32)
    plan, _ = _prefill_ring_plan(cfg, mesh, C)
    if plan is not None:
        o = ring_attend(q.reshape(B, C, G, R, hd), cache, brow, positions,
                        mesh=mesh, plan=plan, window=window,
                        cap=cfg.attn_softcap, kv_scale=kv_scale)
        return o.reshape(B, C, cfg.q_dim) @ params.wo, cache
    kk, vv, _, valid = _gather_pages(cache, brow[None], positions,
                                     window=window)
    if kv_scale:
        kk, vv = dequantize_kv(kk, q.dtype, kv_scale), \
            dequantize_kv(vv, q.dtype, kv_scale)
    else:
        kk, vv = kk.to(q.dtype), vv.to(q.dtype)
    o = _sdpa(q.reshape(B, C, G, R, hd), kk, vv, mask=valid[:, None, None],
              cap=cfg.attn_softcap)
    return o.reshape(B, C, cfg.q_dim) @ params.wo, cache
