"""Fused paged-attention decode: the CUDA kernels ``csrc/paged_attention.cu``,
their plain PyTorch version, the page split they run on, and the cost model.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention_impl`` / ``_kernel``). One query token per slot attends
over its block table's pages in place: no (B, max_len) gather buffer exists.
On the H100 it is bound by bytes (each running page's K and V are read once
per step at ~1 flop per byte). The TPU kernel walks a slot's pages in
sequence; here each block-table row is cut into ranges of ``page_splits``
pages (flash-decoding): kernel 1 runs a block per (range, KV head, slot),
its 4 warps staging pages (or equal tiles of a page too large for shared
memory, ``tile_rows``) with ``cp.async``, two stages in flight, folding
them into an online softmax, and writes each running range's partial
(m, l, acc) to fp32 scratch; kernel 2 merges a (slot, head)'s ranges in
range order. It skips what the Pallas kernel skips: unmapped pages (id 0),
pages past the query position, and pages wholly below the window band; a
whole range that holds none that can run exits at once.

``paged_attention`` runs the plain version for a CPU tensor and launches the
kernels for a CUDA tensor, raising on anything else; it never falls back,
and it never reads the card from the host (no sync: the split comes from
shapes only).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
launches = 0          # wrapper calls that ran the kernels (plain runs: 0)
merge_launches = 0    # launches of the merge pass, one a wrapper call

# the split aims at this many blocks an SM before empty ranges exit: at the
# ring cell's decode (4 slots x 8 heads x M 1024) the running ranges then
# fit the card in one wave, at the serve cell's (8 x 8 x M 64) a warp takes
# 2 of the longest slot's pages (8 blocks an SM: 0.128 / 0.021 ms; 4:
# 0.110 / 0.023; 2: 0.173 / 0.029; H100, chip_smoke.py's ring-decode and
# bf16 cases)
SPLIT_BLOCKS_PER_SM = 4
MIN_SPLIT_PAGES = 4   # a page for each of a block's 4 warps at least

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int8: 3}
_SPLIT_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
               + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p])
_MERGE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_R_MAX, _HD_MAX = 16, 256
_N_SM = {}            # device index -> streaming multiprocessors


def page_splits(B: int, G: int, M: int, n_sm: int) -> int:
    """Pages per range of a block-table row: enough ranges that the
    B * G * ranges blocks of kernel 1 come to about SPLIT_BLOCKS_PER_SM an
    SM, and no fewer than MIN_SPLIT_PAGES pages a range. Shapes only, as
    Python ints (a tensor would make the host wait for the card)."""
    for name, v in (("B", B), ("G", G), ("M", M), ("n_sm", n_sm)):
        if type(v) is not int:
            raise TypeError(f"page_splits: {name} must be an int, got "
                            f"{type(v).__name__}")
    if min(B, G, n_sm) < 1 or M < 0:
        raise ValueError(f"page_splits: B={B} G={G} n_sm={n_sm} must be "
                         f">= 1 and M={M} >= 0")
    ranges = -(-SPLIT_BLOCKS_PER_SM * n_sm // (B * G))
    return max(MIN_SPLIT_PAGES, -(-M // ranges))


def tile_rows(P: int, hd: int, esize: int) -> int:
    """Rows of a page kernel 1 stages at a time for K/V elements of
    ``esize`` bytes: P where the 4 warps' two stages of a page fit in shared
    memory, else the fewest equal tiles that do; 0 for a shape the kernel
    does not take. The rule is the kernel source's (needs the card)."""
    lib = _build.load("paged_attention", [ctypes.c_int] * 3,
                      "paged_attention_tile_rows")
    return lib.paged_attention_tile_rows(P, hd, esize)


def paged_attention_plain(q, kp, vp, ppos, block, position, *,
                          window: int = 0, kv_scale: float = 0.0,
                          cap: float = 0.0):
    """What the kernel computes, in plain PyTorch.

    q: (B, G, R, hd); kp/vp: (n_pages, P, G, hd) (int8 when ``kv_scale``);
    ppos: (n_pages, P) absolute positions (-1 empty); block: (B, M) physical
    page ids (0 = unmapped); position: (B,). Returns (B, G, R, hd) in q's
    dtype.

    A page *runs* unless its id is 0, it starts past the position, or it
    lies wholly below the window band; entries of running pages are masked
    by ``ppos``. The kernel's online softmax starts from m = -1e30, so a row
    whose running pages hold no valid entry weighs each of their entries
    exp(0) = 1 (the mean of their V), and a row with no running page gives
    zeros; both cases arise only on inactive decode rows.
    """
    B, G, R, hd = q.shape
    n_pages, P = ppos.shape
    M = block.shape[1]
    block = block.long()
    pos = position.long()
    pages = torch.arange(M, device=q.device)
    run = (block != 0) & (pages * P <= pos[:, None])              # (B, M)
    if window:
        run &= (pages + 1) * P - 1 > pos[:, None] - window
    k = kp[block].float()                                         # (B,M,P,G,hd)
    v = vp[block].float()
    if kv_scale:
        k = k * kv_scale
        v = v * kv_scale
    s = torch.einsum("bgrd,bmpgd->bgrmp", q.float(), k) * hd ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    kpos = ppos[block]                                            # (B, M, P)
    valid = (kpos >= 0) & (kpos <= pos[:, None, None])
    if window:
        valid &= kpos > pos[:, None, None] - window
    entries = run[:, :, None].expand(B, M, P).reshape(B, 1, 1, M * P)
    valid = (valid & run[:, :, None]).reshape(B, 1, 1, M * P)
    s = torch.where(valid, s.reshape(B, G, R, M * P), NEG_INF)
    w = torch.softmax(s, dim=-1)
    uniform = entries.float() / entries.sum(-1, keepdim=True).clamp_min(1)
    w = torch.where(valid.any(-1, keepdim=True), w, uniform)
    o = torch.einsum("bgrn,bngd->bgrd", w, v.reshape(B, M * P, G, hd))
    return o.to(q.dtype)


def paged_attention(q, kp, vp, ppos, block, position, *, window: int = 0,
                    kv_scale: float = 0.0, cap: float = 0.0):
    """Fused paged decode attention (shapes as ``paged_attention_plain``)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, kp, vp, ppos, block, position,
                                     window=window, kv_scale=kv_scale,
                                     cap=cap)
    return _launch(q, kp, vp, ppos, block, position, window, kv_scale, cap)


def _launch(q, kp, vp, ppos, block, position, window, kv_scale, cap):
    global launches, merge_launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"paged_attention: needs a CPU or CUDA tensor, got {dev}")
    B, G, R, hd = q.shape
    n_pages, P = ppos.shape
    M = block.shape[1]
    checks = (("q", q, (torch.float32, torch.bfloat16, torch.float16),
               (B, G, R, hd)),
              ("kp", kp, tuple(_CODES), (n_pages, P, G, hd)),
              ("vp", vp, (kp.dtype,), (n_pages, P, G, hd)),
              ("ppos", ppos, (torch.int32,), (n_pages, P)),
              ("block", block, (torch.int32,), (B, M)),
              ("position", position, (torch.int32,), (B,)))
    for name, t, dts, shape in checks:
        if t.device != dev or t.dtype not in dts or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"paged_attention: {name} must be a contiguous {dts} "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if not (1 <= R <= _R_MAX and 1 <= hd <= _HD_MAX and P >= 1):
        raise ValueError(
            f"paged_attention: unsupported shape R={R} hd={hd} P={P} "
            f"(R <= {_R_MAX}, hd <= {_HD_MAX})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    pps = page_splits(B, G, M, _N_SM[idx])
    ns = max(1, -(-M // pps))
    part = torch.empty(B * G * ns * R * (hd + 2), dtype=torch.float32,
                       device=dev)
    vec16 = int((hd * kp.element_size()) % 16 == 0
                and kp.data_ptr() % 16 == 0
                and vp.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load("paged_attention", _SPLIT_ARGS, "paged_attention_split")
    rc = lib.paged_attention_split(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ppos.data_ptr(),
        block.data_ptr(), position.data_ptr(), part.data_ptr(),
        B, G, R, hd, P, M, pps, ns, int(window), vec16,
        float(kv_scale), float(cap), float(hd ** -0.5), _CODES[q.dtype],
        _CODES[kp.dtype], stream)
    if rc:
        raise RuntimeError(f"paged_attention: launch failed, cudaError {rc}")
    launches += 1
    lib = _build.load("paged_attention", _MERGE_ARGS, "paged_attention_merge")
    rc = lib.paged_attention_merge(
        position.data_ptr(), part.data_ptr(), out.data_ptr(), B, G, R, hd,
        P, M, pps, ns, int(window), _CODES[q.dtype], stream)
    if rc:
        raise RuntimeError(
            f"paged_attention: merge launch failed, cudaError {rc}")
    merge_launches += 1
    return out


def page_hbm_bytes(page_size: int, n_kv_heads: int, head_dim: int, *,
                   kv_bytes: int = 4) -> int:
    """Device-memory bytes one live page streams through the fused kernel:
    K + V entries at the cache dtype width plus the int32 ``ppos`` row."""
    return 2 * page_size * n_kv_heads * head_dim * kv_bytes + 4 * page_size


def decode_hbm_bytes(live_pages: int, page_size: int, n_kv_heads: int,
                     head_dim: int, *, kv_bytes: int = 4, batch: int = 1,
                     n_heads: int = 0, q_bytes: int = 4,
                     max_pages: int = 0) -> int:
    """Per-step attention bytes of the fused paged decode: every live page
    streamed once (each KV head's slice exactly once), plus the query/output
    vectors and the (B, max_pages) block table + (B,) positions. O(live
    pages), not O(slots x max_len)."""
    nh = n_heads or n_kv_heads
    qo = 2 * batch * nh * head_dim * q_bytes
    tables = batch * 4 * (max_pages + 1)        # block rows + positions, int32
    return live_pages * page_hbm_bytes(page_size, n_kv_heads, head_dim,
                                       kv_bytes=kv_bytes) + qo + tables
