"""Ring-attention chunked prefill: the CUDA kernel ``csrc/ring_hop.cu`` for
the hops of one ring step, its plain PyTorch version, the ring over sequence
shards, and the per-device cost account.

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

The kernel has two designs, picked by ``select_hop_design``: "tc" (bf16
queries with bf16 or int8 K/V: tensor-core tiles, each K/V tile shared by
the query heads of a GQA group, P.V with P split into two bf16 halves so
the sums keep fp32 accuracy) and "simt" (fp32 queries or K/V: fp32 FMAs).
``launches`` counts launches, ``design_launches`` the launches of each
design.

``ring_hop`` (one hop) and ``ring_hop_step`` (the hops of every shard that
runs at one ring step, in one launch) UPDATE m, l and acc IN PLACE (and
return them), on both devices: a CPU tensor takes ``ring_hop_plain``, a
CUDA tensor launches the kernel, anything else raises; they never fall
back. A ``meta`` tensor (the dry-run's trace) takes the card's path up to
the launch; ``work`` is a hop's work, which ``_launch`` enters into an
active counting mode (``repro_torch.cost``) for each hop it runs.

``ring_chunk_attention`` runs the n sequence shards of ``plan`` on the
mesh's one device: every shard's resident queries and its K/V live in that
device's memory, and the ring's rotation is a re-index of the shard stacks
(shard d meets K/V shard (d - t) mod n at hop t, as after t ``ppermute``
steps), so no K/V bytes move between hops; the shards that run at hop t go
in one ``ring_hop_step``. Whole hops are skipped on position bounds,
decided on the host: the bounds of all shards come across in ONE
device-to-host copy per call (one sync per layer and chunk), because a
skipped hop then costs no launch at all, where a skip on the device would
still launch every hop and read its positions.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import cost
from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset (plain runs: 0)
design_launches = {"tc": 0, "simt": 0}
hops_run = 0          # shard hops the ring ran (either device)
hops_skipped = 0      # shard hops skipped whole on position bounds
steps_run = 0         # ring steps with at least one shard's hop to run

NEG_INF = -1e30
_BIG = 2 ** 30
TILE = 64             # the kernel's query and key tile
MAX_PAIRS = 64        # shards one launch runs

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_DESIGN_CODES = {"simt": 0, "tc": 1}
_TC_HD = (64, 128)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
    + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_HD_MAX = 256


def select_hop_design(q_dtype, kv_dtype, hd: int) -> str:
    """The kernel design for a hop: ``"tc"`` (tensor cores) for bf16
    queries with bf16 or int8 K/V at head width 64 or 128, ``"simt"`` (fp32
    FMAs) for anything else the kernel takes."""
    if q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8) \
            and hd in _TC_HD:
        return "tc"
    return "simt"


def work(B, H, KVH, Cl, Ll, hd, q_bytes, kv_bytes, pairs):
    """(FLOPs, bytes) of one hop: q, K, V and the positions read once, m,
    l and acc read and written once; Q.K^T and P.V over the ``pairs``
    (query, key) entries the hop's positions make visible, 4 hd FLOP a
    pair per head."""
    nbytes = (B * H * Cl * hd * q_bytes + 2 * B * KVH * Ll * hd * kv_bytes
              + 4 * (B * Cl + B * Ll) + 2 * 4 * (2 * B * H * Cl)
              + 2 * 4 * B * H * Cl * hd)
    return 4.0 * H * hd * pairs, nbytes


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
    _check_cuda(qf.device)
    _launch([t[None] for t in (qf, kf, vf, qp, kvp, m, l, acc)], [(0, 0)],
            window, cap, kv_scale)
    return m, l, acc


def ring_hop_step(qf, kf, vf, qp, kvp, m, l, acc, pairs, *, window: int = 0,
                  cap: float = 0.0, kv_scale: float = 0.0):
    """The hops of one ring step: for each (d, src) in ``pairs``, advance
    shard d's state by K/V shard src, in place, all in one launch.

    Stacks over n shards, each entry shaped as in ``ring_hop``: qf
    (n, B, H, Cl, hd), kf/vf (n, B, KVH, Ll, hd), qp (n, B, Cl), kvp
    (n, B, Ll), m/l (n, B, H, Cl, 1), acc (n, B, H, Cl, hd). The d of
    ``pairs`` must be distinct (each shard's state is written by one hop);
    a src may repeat. Returns (m, l, acc)."""
    pairs = [(int(d), int(s)) for d, s in pairs]
    n = qf.shape[0] if qf.dim() == 5 else -1
    shapes = [t.shape for t in (qf, kf, vf, qp, kvp, m, l, acc)]
    if n < 0 or any(len(sh) == 0 or sh[0] != n for sh in shapes):
        raise ValueError(f"ring_hop_step: every stack needs the same leading "
                         f"shard dimension, got {[tuple(sh) for sh in shapes]}")
    for d, s in pairs:
        if not (0 <= d < n and 0 <= s < n):
            raise ValueError(f"ring_hop_step: pair {(d, s)} out of range "
                             f"for {n} shards")
    if len({d for d, _ in pairs}) != len(pairs):
        raise ValueError(f"ring_hop_step: repeated destination shard in "
                         f"{pairs}")
    B, H, Cl, hd = qf.shape[1:]
    KVH, Ll = kf.shape[2], kf.shape[3]
    want = {"kf": (n, B, KVH, Ll, hd), "vf": (n, B, KVH, Ll, hd),
            "qp": (n, B, Cl), "kvp": (n, B, Ll), "m": (n, B, H, Cl, 1),
            "l": (n, B, H, Cl, 1), "acc": (n, B, H, Cl, hd)}
    for name, t in zip(want, (kf, vf, qp, kvp, m, l, acc)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ring_hop_step: {name} must be {want[name]} "
                             f"beside q {tuple(qf.shape)}, got "
                             f"{tuple(t.shape)}")
    if qf.device.type == "cpu":
        return ring_hop_step_plain(qf, kf, vf, qp, kvp, m, l, acc, pairs,
                                   window=window, cap=cap, kv_scale=kv_scale)
    if pairs:
        _launch((qf, kf, vf, qp, kvp, m, l, acc), pairs, window, cap,
                kv_scale)
    return m, l, acc


def ring_hop_step_plain(qf, kf, vf, qp, kvp, m, l, acc, pairs, *,
                        window: int = 0, cap: float = 0.0,
                        kv_scale: float = 0.0):
    """``ring_hop_step``'s plain version: ``ring_hop_plain`` pair by pair on
    the shards' views, so the stacks update in place."""
    for d, s in pairs:
        ring_hop_plain(qf[d], kf[s], vf[s], qp[d], kvp[s], m[d], l[d],
                       acc[d], window=window, cap=cap, kv_scale=kv_scale)
    return m, l, acc


def _check_cuda(dev):
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"ring_hop: needs a CPU or CUDA tensor, got {dev}")


def _launch(stacks, pairs, window, cap, kv_scale):
    global launches
    qf, kf, vf, qp, kvp, m, l, acc = stacks
    dev = qf.device
    _check_cuda(dev)
    if qf.dim() != 5 or qf.dtype not in _Q_CODES:
        raise ValueError(f"ring_hop: q must be (B,H,Cl,hd) fp32 or bf16, "
                         f"got {qf.dtype} {tuple(qf.shape[1:])}")
    n, B, H, Cl, hd = qf.shape
    KVH, Ll = kf.shape[2], kf.shape[3]
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
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != (n,) + shape or not t.is_contiguous():
            raise ValueError(
                f"ring_hop: {name} must be a contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape[1:])} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if hd % 16 or not 0 < hd <= _HD_MAX or KVH == 0 or H % KVH:
        raise ValueError(f"ring_hop: needs hd a multiple of 16 up to "
                         f"{_HD_MAX} and H a multiple of KVH; got hd={hd}, "
                         f"H={H}, KVH={KVH}")
    if len(pairs) > MAX_PAIRS or B * len(pairs) > 65535:
        raise ValueError(f"ring_hop: at most {MAX_PAIRS} shards and 65535 "
                         f"batch rows a launch, got {len(pairs)} x {B}")
    if acc.numel() == 0 or Ll == 0:
        return
    design = select_hop_design(qf.dtype, kf.dtype, hd)
    if design == "tc" and any(t.data_ptr() % 16 for t in (qf, kf, vf)):
        raise ValueError("ring_hop: design tc needs q, k and v 16-byte "
                         "aligned")
    if cost.active():
        for d, src in pairs:
            seen = (B * Cl * Ll if dev.type == "meta" else
                    int(visible(qp[d], kvp[src], window).sum()))
            cost.kernel("ring_hop", design, *work(
                B, H, KVH, Cl, Ll, hd, qf.element_size(), kf.element_size(),
                seen))
    if dev.type == "meta":
        return
    lib = _build.load("ring_hop", _ARGTYPES, "ring_hop_step")
    flat = (ctypes.c_int * (2 * len(pairs)))(*[i for p in pairs for i in p])
    rc = lib.ring_hop_step(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                           qp.data_ptr(), kvp.data_ptr(), m.data_ptr(),
                           l.data_ptr(), acc.data_ptr(),
                           ctypes.addressof(flat), len(pairs), B, H, KVH,
                           Cl, Ll, hd, int(window), float(cap),
                           float(kv_scale), float(hd ** -0.5),
                           _Q_CODES[qf.dtype], _KV_CODES[kf.dtype],
                           _DESIGN_CODES[design],
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"ring_hop: launch failed, cudaError {rc}")
    launches += 1
    design_launches[design] += 1


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
    once to the kernel's tile. Then n ring steps, each one
    ``ring_hop_step`` over the shards whose hop runs, and ``acc / max(l,
    1e-30)``."""
    if q.device != mesh.device:
        raise ValueError(f"ring_chunk_attention: q on {q.device}, the mesh "
                         f"on {mesh.device}")
    global hops_run, hops_skipped, steps_run
    B, C, G, R, hd = q.shape
    n = plan.n_shards
    H = G * R
    q = _pad_tail(q, 1, n, 0)
    q_pos = _pad_tail(q_pos.to(torch.int32), 1, n, -1)
    k = _pad_tail(k, 1, n, 0)
    v = _pad_tail(v, 1, n, 0)
    kv_pos = _pad_tail(kv_pos.to(torch.int32), 1, n, -1)
    Cp, Lp = q.shape[1], k.shape[1]
    Cl, Ll = Cp // n, Lp // n
    inv = None
    if window == 0 and n > 1:
        # shard d holds rows d, d + n, ...: row i goes to (i % n) * Cl + i // n.
        # Built on the device: a host index copied there would wait for the
        # stream, a sync of its own beside the bounds' one.
        rows = torch.arange(Cp, device=q.device)
        stripe = rows.reshape(Cl, n).t().reshape(-1)
        inv = rows % n * Cl + rows // n
        q, q_pos = q[:, stripe], q_pos[:, stripe]
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
        pairs = []
        for d in range(n):
            src = (d - hop) % n
            # whole-hop skip: the visiting shard is empty (kv_max < 0) or
            # wholly in the future, or wholly behind the window band
            run = kv_max[src] >= 0 and kv_min[src] <= q_max[d]
            if window:
                run = run and kv_max[src] > q_min[d] - window
            if run:
                pairs.append((d, src))
        hops_run += len(pairs)
        hops_skipped += n - len(pairs)
        if pairs:
            steps_run += 1
            ring_hop_step(qf, kf, vf, qp, kvp, m, l, acc, pairs,
                          window=window, cap=cap, kv_scale=kv_scale)
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
