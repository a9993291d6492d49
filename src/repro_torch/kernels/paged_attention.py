"""Fused paged-attention decode: the CUDA kernel ``csrc/paged_attention.cu``,
its plain PyTorch version, and the kernel's cost model.

Replaces the Pallas TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_attention_impl`` / ``_kernel``). One query token per slot attends
over its block table's pages in place: no (B, max_len) gather buffer exists.
On the H100 it is bound by bytes (each live page's K and V are read once per
step at ~4 flops per byte); the kernel runs one block per (slot, KV head),
walks the slot's pages in a loop, stages each page's K/V slice for its head
in shared memory (dequantising int8 there) and keeps the online-softmax
accumulator in registers. It skips what the Pallas kernel skips: unmapped
pages (id 0), pages past the query position, and pages wholly below the
window band.

``paged_attention`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on anything else; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
launches = 0          # kernel launches since the last reset (plain runs: 0)

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int8: 3}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_R_MAX, _HD_MAX, _SMEM_MAX = 16, 256, 227 * 1024


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


def _smem_bytes(R: int, hd: int, P: int) -> int:
    return 4 * (R * hd + 2 * P * hd + R * P) + 4 * P


def _launch(q, kp, vp, ppos, block, position, window, kv_scale, cap):
    global launches
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
    if not (1 <= R <= _R_MAX and 1 <= hd <= _HD_MAX and P >= 1
            and _smem_bytes(R, hd, P) <= _SMEM_MAX):
        raise ValueError(
            f"paged_attention: unsupported shape R={R} hd={hd} P={P} "
            f"(R <= {_R_MAX}, hd <= {_HD_MAX}, staging <= {_SMEM_MAX} B)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("paged_attention", _ARGTYPES)
    rc = lib.paged_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ppos.data_ptr(),
        block.data_ptr(), position.data_ptr(), out.data_ptr(),
        B, G, R, hd, P, M, int(window), float(kv_scale), float(cap),
        float(hd ** -0.5), _CODES[q.dtype], _CODES[kp.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"paged_attention: launch failed, cudaError {rc}")
    launches += 1
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
