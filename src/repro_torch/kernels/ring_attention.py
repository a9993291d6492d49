"""Ring-attention chunked prefill: the CUDA kernel ``csrc/ring_hop.cu`` for
one hop, its plain PyTorch version, the ring over sequence shards, and the
per-device cost account.

Replaces the Pallas TPU kernel ``src/repro/kernels/ring_attention.py``
(``_hop`` / ``_hop_kernel``) and its ``ring_chunk_attention``. A hop
advances the online-softmax state (m, l, acc) of one shard's resident
queries by one visiting K/V shard. Masking is by explicit position
(``q_pos`` / ``kv_pos``, -1 = empty): causal ``kv <= q``, plus the band
``kv > q - window`` when ``window`` > 0. Scores are fp32 from the upcast
inputs (int8 K/V times ``kv_scale``), optionally soft-capped; masked
entries take -1e30 in the row max and weigh exactly 0 in the sums, so a
row with nothing visible keeps its state and a tile whose entries are all
masked changes nothing. That makes the result independent of the tiling:
the kernel uses its own 64 x 64 tiles and skips every tile with no visible
entry, which covers the tiles the Pallas kernel skips by position bounds.

``ring_hop`` UPDATES m, l and acc IN PLACE (and returns them), on both
devices: a CPU tensor takes ``ring_hop_plain``, a CUDA tensor launches the
kernel, anything else raises; it never falls back.

``ring_chunk_attention`` runs the n sequence shards of ``plan`` one after
another on the mesh's one device: every shard's resident queries and its
K/V live in that device's memory, and the ring's rotation is a re-index of
the shard list (shard d meets K/V shard (d - t) mod n at hop t, as after t
``ppermute`` steps), so no K/V bytes move between hops. Whole hops are
skipped on position bounds, decided on the host: the bounds of all shards
come across in ONE device-to-host copy per call (one sync per layer and
chunk), because a skipped hop then costs no launch at all, where a skip on
the device would still launch every hop and read its positions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset (plain runs: 0)
hops_run = 0          # hops the ring ran (either device)
hops_skipped = 0      # hops skipped whole on position bounds

NEG_INF = -1e30
_BIG = 2 ** 30
TILE = 64             # the kernel's query and key tile

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
    + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_HD_MAX = 256


def visible(qp, kvp, window: int = 0):
    """(B, Cl, Ll) bool: the (query, key) pairs a hop attends to."""
    q, k = qp[:, :, None], kvp[:, None, :]
    mask = (q >= 0) & (k >= 0) & (k <= q)
    if window:
        mask &= k > q - window
    return mask


def ring_hop_plain(qf, kf, vf, qp, kvp, m, l, acc, *, window: int = 0,
                   cap: float = 0.0, kv_scale: float = 0.0):
    """What the kernel (and the Pallas ``_hop_kernel``) computes, over the
    whole hop at once, in fp32. Shapes as ``ring_hop``; m, l and acc are
    updated in place and returned."""
    B, H, Cl, hd = qf.shape
    KVH, Ll = kf.shape[1], kf.shape[2]
    rep = H // KVH
    q = qf.float().reshape(B, KVH, rep, Cl, hd)
    k, v = kf.float()[:, :, None], vf.float()[:, :, None]
    if kv_scale:
        k, v = k * kv_scale, v * kv_scale
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5        # (B,KVH,rep,Cl,Ll)
    if cap:
        s = cap * torch.tanh(s / cap)
    mask = visible(qp, kvp, window)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m_prev = m.reshape(B, KVH, rep, Cl, 1)
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    # the mask, not the exp, zeroes a row still at -1e30
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m_prev - m_new)
    l.copy_((l.reshape(B, KVH, rep, Cl, 1) * alpha
             + p.sum(-1, keepdim=True)).reshape(l.shape))
    acc.copy_((acc.reshape(B, KVH, rep, Cl, hd) * alpha
               + p @ v).reshape(acc.shape))
    m.copy_(m_new.reshape(m.shape))
    return m, l, acc


def ring_hop(qf, kf, vf, qp, kvp, m, l, acc, *, window: int = 0,
             cap: float = 0.0, kv_scale: float = 0.0):
    """Advance the online-softmax state by one hop's K/V, in place.

    qf: (B, H, Cl, hd) fp32 or bf16; kf/vf: (B, KVH, Ll, hd) fp32, bf16 or
    int8 (times ``kv_scale`` when it is nonzero), H a multiple of KVH and
    query head h reading KV head h // (H // KVH); qp: (B, Cl), kvp: (B, Ll)
    int32 absolute positions, -1 empty; m/l: (B, H, Cl, 1) fp32; acc:
    (B, H, Cl, hd) fp32. Returns (m, l, acc)."""
    if qf.device.type == "cpu":
        return ring_hop_plain(qf, kf, vf, qp, kvp, m, l, acc, window=window,
                              cap=cap, kv_scale=kv_scale)
    return _launch(qf, kf, vf, qp, kvp, m, l, acc, window, cap, kv_scale)


def _launch(qf, kf, vf, qp, kvp, m, l, acc, window, cap, kv_scale):
    global launches
    dev = qf.device
    if dev.type != "cuda":
        raise ValueError(f"ring_hop: needs a CPU or CUDA tensor, got {dev}")
    if qf.dim() != 4 or qf.dtype not in _Q_CODES:
        raise ValueError(f"ring_hop: q must be (B,H,Cl,hd) fp32 or bf16, "
                         f"got {qf.dtype} {tuple(qf.shape)}")
    B, H, Cl, hd = qf.shape
    KVH, Ll = kf.shape[1], kf.shape[2]
    if kf.dtype not in _KV_CODES:
        raise ValueError(f"ring_hop: K/V must be fp32, bf16 or int8, got "
                         f"{kf.dtype}")
    for name, t, dtype, shape in (
            ("q", qf, qf.dtype, (B, H, Cl, hd)),
            ("k", kf, kf.dtype, (B, KVH, Ll, hd)),
            ("v", vf, kf.dtype, (B, KVH, Ll, hd)),
            ("q_pos", qp, torch.int32, (B, Cl)),
            ("kv_pos", kvp, torch.int32, (B, Ll)),
            ("m", m, torch.float32, (B, H, Cl, 1)),
            ("l", l, torch.float32, (B, H, Cl, 1)),
            ("acc", acc, torch.float32, (B, H, Cl, hd))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"ring_hop: {name} must be a contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if hd % 16 or not 0 < hd <= _HD_MAX or KVH == 0 or H % KVH:
        raise ValueError(f"ring_hop: needs hd a multiple of 16 up to "
                         f"{_HD_MAX} and H a multiple of KVH; got hd={hd}, "
                         f"H={H}, KVH={KVH}")
    if acc.numel() == 0 or Ll == 0:
        return m, l, acc
    lib = _build.load("ring_hop", _ARGTYPES)
    rc = lib.ring_hop(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                      qp.data_ptr(), kvp.data_ptr(), m.data_ptr(),
                      l.data_ptr(), acc.data_ptr(), B, H, KVH, Cl, Ll, hd,
                      int(window), float(cap), float(kv_scale),
                      float(hd ** -0.5), _Q_CODES[qf.dtype],
                      _KV_CODES[kf.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ring_hop: launch failed, cudaError {rc}")
    launches += 1
    return m, l, acc


def _pad_tail(x, dim: int, to: int, fill):
    pad = -x.shape[dim] % to
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def ring_chunk_attention(q, k, v, q_pos, kv_pos, *, mesh, plan,
                         window: int = 0, cap: float = 0.0,
                         kv_scale: float = 0.0):
    """Sequence-parallel attention of one admission chunk over its context.

    q: (B, C, G, R, hd) resident queries; k/v: (B, L, G, hd) the chunk's
    whole visible context (cache and in-chunk entries) at storage dtype
    (int8 when ``kv_scale`` > 0, dequantised per hop inside the kernel);
    q_pos: (B, C) absolute positions; kv_pos: (B, L) absolute positions, -1
    empty. Masking is causal plus the window band when ``window`` > 0, as
    in the single-device admission cell. Returns (B, C, G, R, hd) in q's
    dtype.

    ``plan`` is a ``dist.sharding.PrefillPlan``: C and L pad to multiples
    of ``plan.n_shards``; causal chunks stripe their query rows (shard d
    holds rows d, d+n, d+2n, ...) so every shard sees early and late
    positions, window chunks stay contiguous so whole hops behind the band
    skip; K/V and positions split contiguously; each shard's lengths pad
    once to the kernel's tile. Then n hops per shard and ``acc / max(l,
    1e-30)``."""
    if q.device != mesh.device:
        raise ValueError(f"ring_chunk_attention: q on {q.device}, the mesh "
                         f"on {mesh.device}")
    global hops_run, hops_skipped
    B, C, G, R, hd = q.shape
    n = plan.n_shards
    H = G * R
    q = _pad_tail(q, 1, n, 0)
    q_pos = _pad_tail(q_pos.to(torch.int32), 1, n, -1)
    k = _pad_tail(k, 1, n, 0)
    v = _pad_tail(v, 1, n, 0)
    kv_pos = _pad_tail(kv_pos.to(torch.int32), 1, n, -1)
    Cp, Lp = q.shape[1], k.shape[1]
    inv = None
    if window == 0 and n > 1:
        stripe = torch.cat([torch.arange(d, Cp, n) for d in range(n)])
        inv = torch.argsort(stripe).to(q.device)
        stripe = stripe.to(q.device)
        q, q_pos = q[:, stripe], q_pos[:, stripe]
    Cl, Ll = Cp // n, Lp // n
    # shard-major layouts: qf[d] (B, H, Cl, hd), kf[d] (B, G, Ll, hd)
    qf = q.reshape(B, n, Cl, H, hd).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(B, n, Cl).transpose(0, 1)
    kf = k.reshape(B, n, Ll, G, hd).permute(1, 0, 3, 2, 4)
    vf = v.reshape(B, n, Ll, G, hd).permute(1, 0, 3, 2, 4)
    kvp = kv_pos.reshape(B, n, Ll).transpose(0, 1)
    qf = _pad_tail(qf, 3, min(TILE, Cl), 0).contiguous()
    qp = _pad_tail(qp, 2, min(TILE, Cl), -1).contiguous()
    kf = _pad_tail(kf, 3, min(TILE, Ll), 0).contiguous()
    vf = _pad_tail(vf, 3, min(TILE, Ll), 0).contiguous()
    kvp = _pad_tail(kvp, 2, min(TILE, Ll), -1).contiguous()
    Clp = qf.shape[3]
    m = torch.full((n, B, H, Clp, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((n, B, H, Clp, hd), dtype=torch.float32,
                      device=q.device)
    qv, kvv = qp >= 0, kvp >= 0
    bounds = torch.stack([
        torch.where(qv, qp, -1).amax((1, 2)),
        torch.where(qv, qp, _BIG).amin((1, 2)),
        torch.where(kvv, kvp, _BIG).amin((1, 2)),
        torch.where(kvv, kvp, -1).amax((1, 2))]).tolist()   # the host sync
    q_max, q_min, kv_min, kv_max = bounds
    for hop in range(n):
        for d in range(n):
            src = (d - hop) % n
            # whole-hop skip: the visiting shard is empty (kv_max < 0) or
            # wholly in the future, or wholly behind the window band
            run = kv_max[src] >= 0 and kv_min[src] <= q_max[d]
            if window:
                run = run and kv_max[src] > q_min[d] - window
            if not run:
                hops_skipped += 1
                continue
            hops_run += 1
            ring_hop(qf[d], kf[src], vf[src], qp[d], kvp[src], m[d], l[d],
                     acc[d], window=window, cap=cap, kv_scale=kv_scale)
    o = (acc / l.clamp_min(1e-30))[:, :, :, :Cl]          # (n,B,H,Cl,hd)
    o = o.reshape(n, B, G, R, Cl, hd).permute(1, 0, 4, 2, 3, 5)
    o = o.reshape(B, Cp, G, R, hd).to(q.dtype)
    if inv is not None:
        o = o[:, inv]
    return o[:, :C]


# ------------------------------------------------- per-device cost account --

def prefill_attn_flops(chunk_len: int, kv_len: int, n_heads: int,
                       head_dim: int) -> float:
    """Attention FLOPs of one admission chunk: QK^T + PV over the full
    visible context (4 * C * L * H * hd), the dense upper bound both paths
    share."""
    return 4.0 * chunk_len * kv_len * n_heads * head_dim


def sharded_prefill_attn_flops(chunk_len: int, kv_len: int, n_heads: int,
                               head_dim: int, *, n_shards: int) -> float:
    """Per-shard ring FLOPs: each shard's resident C/n queries visit the
    whole context across the ring's n hops, 1/n_shards of the total."""
    return prefill_attn_flops(math.ceil(chunk_len / n_shards), kv_len,
                              n_heads, head_dim)


def prefill_hbm_bytes(chunk_len: int, kv_len: int, n_kv_heads: int,
                      head_dim: int, *, n_heads: int, kv_bytes: int = 4,
                      q_bytes: int = 4) -> int:
    """Device-memory traffic of one chunk's attention: read Q and write O
    (all heads), read K and V once (kv heads), plus the int32 position
    lanes."""
    qo = 2 * chunk_len * n_heads * head_dim * q_bytes
    kv = 2 * kv_len * n_kv_heads * head_dim * kv_bytes
    pos = 4 * (chunk_len + kv_len)
    return qo + kv + pos


def sharded_prefill_hbm_bytes(chunk_len: int, kv_len: int, n_kv_heads: int,
                              head_dim: int, *, n_shards: int, n_heads: int,
                              kv_bytes: int = 4, q_bytes: int = 4) -> int:
    """Per-shard ring bytes: the single-device account applied to one
    shard's resident queries and initial K/V shard."""
    return prefill_hbm_bytes(math.ceil(chunk_len / n_shards),
                             math.ceil(kv_len / n_shards), n_kv_heads,
                             head_dim, n_heads=n_heads, kv_bytes=kv_bytes,
                             q_bytes=q_bytes)
