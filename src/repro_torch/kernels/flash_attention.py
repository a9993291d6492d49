"""Blocked online-softmax (flash) attention: the CUDA kernel
``csrc/flash_attention.cu``, its plain PyTorch version, and the autograd
Function the model calls.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention`` / ``_kernel``). q (B,H,Sq,hd) attends over k/v
(B,KVH,Skv,hd); q head h reads KV head ``h // (H // KVH)``. Positions are
START-aligned (query row r sits at position r, key column c at c), unlike
``ref.mha_ref``'s end alignment; the two agree when Sq == Skv. Scores and
the softmax are fp32, the logits optionally soft-capped, masked entries
(causal, window, the padded KV tail) set to -1e30, and ``p`` cast to v's
dtype before P.V; the output is cast to q's dtype.

The Pallas kernel runs a (bq, bk) grid of blocks and skips block (i, j)
unless

    causal: j*bk < (i+1)*bq
    window: i*bq - (j+1)*bk < window
    stride: (i*bq - j*bk <= 2*bq) | ((i - j*bk // bq) % stride == 0)

the last being the ``kv_keep_stride`` perforation (Pliant's loop perforation
on the attention loop; a rule RELATIVE to the query block, not the model's
absolute ``_causal_chunked`` rule). A skipped block contributes nothing; a
masked entry of a block that runs contributes ``exp(-1e30 - m)``, which is
0 unless the row's max m is still -1e30, so a row whose every visible entry
is masked gives the mean of V over the masked entries of its running blocks
(padded columns count, with V = 0), exactly as the Pallas body does. The
plain version and the kernel both evaluate the rule on the caller's
``(bq, bk)``, clipped to ``(min(bq, Sq), min(bk, Skv))``, whatever tiles the
kernel uses inside. Only the tests and ``chip_smoke.py`` pass another grid
or a stride > 1 here, to reproduce the Pallas function: the model calls
the kernel at (128, 128) and stride 1, where causal rows are never fully
masked and the grid changes no result.

The kernel has two designs (``select_flash_design``): "tiled" for fp32 at hd
64 or 128 (the training path: 8 x 8 register tiles, K/V streamed through
``cp.async`` stages, 64-row query tiles over 128-key tiles whose visits
``tile_walk`` mirrors) and "simple" for bf16 and other head sizes.
``flash_attention`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on anything else; it never falls back.
``FlashAttention`` wraps it for autograd. The Pallas call has no JVP rule,
so the JAX package has no gradient through this kernel; the backward here
is the VJP of ``flash_attention_plain``, recomputed one block of ~1024 query
rows at a time so that its scratch stays at (B, H, 1024, Skv) fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0          # kernel launches since the last reset (plain runs: 0)
design_launches = {"tiled": 0, "simple": 0}   # the same, by design

NEG_INF = -1e30
ROW_BLOCK = 1024      # query rows per block of the plain version / backward
TILE_Q, TILE_K = 64, 128   # the tiled design's query rows and keys a tile

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGNS = {"simple": 0, "tiled": 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 \
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_HD_MAX = 256


def select_flash_design(dtype, hd: int) -> str:
    """The kernel design for inputs of ``dtype`` and head size ``hd``:
    "tiled" for fp32 at hd 64 or 128 (a thread owns 4 output dims of every
    64), "simple" otherwise."""
    if dtype == torch.float32 and hd in (64, 128):
        return "tiled"
    return "simple"


def _clip_blocks(Sq, Skv, bq, bk):
    return min(bq, Sq), min(bk, Skv)


def block_runs(qpos, kpos, *, causal, window, kv_keep_stride, bq, bk):
    """(len(qpos), len(kpos)) bool: whether the block holding each entry
    runs under the Pallas kernel's skip rule on the (bq, bk) grid."""
    i = (qpos // bq)[:, None]
    j = (kpos // bk)[None, :]
    run = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                     device=qpos.device)
    if causal:
        run &= j * bk < (i + 1) * bq
    if window:
        run &= (i * bq - (j + 1) * bk) < window
    if kv_keep_stride > 1:
        near = (i * bq - j * bk) <= 2 * bq
        run &= near | (torch.remainder(i - (j * bk) // bq,
                                       kv_keep_stride) == 0)
    return run


def tile_walk(Sq, Skv, *, causal, window, kv_keep_stride, bq, bk):
    """The key tiles (of TILE_K keys) the tiled design visits for each
    query tile (of TILE_Q rows), in order: a list per query tile. The
    kernel's rule, on the caller's (bq, bk) grid clipped to the shapes:
    causal keys stop at the running blocks' reach of the tile's last row,
    a window starts the walk at the first tile that can hold a running
    block's key, and a tile is visited when it keeps an entry
    (``block_runs & entry_mask``) or a row that has kept none yet has an
    entry of a running block in it (that entry weighs exp(-1e30 - m) = 1
    while the row's max m is still -1e30)."""
    bq, bk = _clip_blocks(Sq, Skv, bq, bk)
    n_kpad = -(-Skv // bk) * bk
    walks = []
    for q0 in range(0, Sq, TILE_Q):
        rows = torch.arange(q0, min(q0 + TILE_Q, Sq))
        kend = n_kpad
        if causal:
            i_last = (min(q0 + TILE_Q, Sq) - 1) // bq
            kend = min(kend, -(-((i_last + 1) * bq) // bk) * bk)
        t0 = max(0, (q0 // bq) * bq - window - bk) // TILE_K if window else 0
        seen = torch.zeros(rows.shape[0], dtype=torch.bool)
        walk = []
        for t in range(t0, -(-kend // TILE_K)):
            keys = torch.arange(t * TILE_K, (t + 1) * TILE_K)
            inc = block_runs(rows, keys, causal=causal, window=window,
                             kv_keep_stride=kv_keep_stride, bq=bq, bk=bk) \
                & (keys < n_kpad)[None]
            keep = inc & entry_mask(rows, keys, causal=causal, window=window,
                                    n_kv=Skv)
            if keep.any() or (inc.any(1) & ~seen).any():
                walk.append(t)
                seen |= keep.any(1)
        walks.append(walk)
    return walks


def entry_mask(qpos, kpos, *, causal, window, n_kv):
    """(len(qpos), len(kpos)) bool: the entries the kernel's mask keeps."""
    q, k = qpos[:, None], kpos[None, :]
    keep = k < n_kv
    if causal:
        keep = keep & (k <= q)
    if window:
        keep = keep & (k > q - window)
    return keep


def _plain_rows(q, k, v, row0, *, causal, window, cap, kv_keep_stride, bq,
                bk, n_kv):
    """Output rows ``row0 .. row0 + q.shape[2]`` of the plain version. k/v
    are already padded to a multiple of bk; differentiable in q, k, v."""
    B, H, R, hd = q.shape
    KVH, Skvp = k.shape[1], k.shape[2]
    rep = H // KVH
    f32 = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    qf = q.to(f32).reshape(B, KVH, rep, R, hd)
    kf = k.to(f32)[:, :, None]
    vf = v.to(f32)[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * hd ** -0.5     # (B,KVH,rep,R,Skvp)
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(row0, row0 + R, device=dev)
    kpos = torch.arange(Skvp, device=dev)
    run = block_runs(qpos, kpos, causal=causal, window=window,
                     kv_keep_stride=kv_keep_stride, bq=bq, bk=bk)
    keep = run & entry_mask(qpos, kpos, causal=causal, window=window,
                            n_kv=n_kv)
    # masked entries of running blocks at -1e30, skipped blocks at -inf
    fill = torch.where(run, torch.tensor(NEG_INF, dtype=f32, device=dev),
                       torch.tensor(float("-inf"), dtype=f32, device=dev))
    s = torch.where(keep, s, fill)
    m = s.amax(-1, keepdim=True).detach().clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = p.to(v.dtype).to(f32) @ vf
    out = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, R, hd).to(q.dtype)


def _pad_kv(k, v, bk):
    pad = -k.shape[2] % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    return k, v


def _row_walk(Sq, k, v, *, causal, bq, bk):
    """The plain version's walk, shared by the forward and its VJP so that
    both block the rows and reach the keys alike: the grid clipped to the
    shapes, k/v padded to a multiple of bk, and ``(r0, r1, ke)`` for each
    block of query rows ``r0 .. r1`` (a multiple of bq near ROW_BLOCK, so a
    row's block index stays ``row // bq``) with ``ke`` the keys it can
    reach: under the causal rule no block past the last row's diagonal
    runs, so those keys, which would add exact zeros, are left out."""
    bq, bk = _clip_blocks(Sq, k.shape[2], bq, bk)
    kp, vp = _pad_kv(k, v, bk)
    R = bq * max(1, ROW_BLOCK // bq)
    spans = []
    for r0 in range(0, Sq, R):
        r1 = min(r0 + R, Sq)
        ke = kp.shape[2]
        if causal:
            ke = min(ke, -(-((r1 - 1) // bq + 1) * bq // bk) * bk)
        spans.append((r0, r1, ke))
    return bq, bk, kp, vp, spans


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          cap: float = 0.0, kv_keep_stride: int = 1,
                          bq: int = 128, bk: int = 128):
    """What the kernel (and the Pallas ``_kernel``) computes, in plain
    PyTorch, one block of query rows at a time: fp32 scores and softmax
    over the entries of the running blocks (an fp64 input is computed in
    fp64, for gradient checks). Shapes as ``flash_attention``."""
    bq, bk, kp, vp, spans = _row_walk(q.shape[2], k, v, causal=causal,
                                      bq=bq, bk=bk)
    kw = dict(causal=causal, window=window, cap=cap,
              kv_keep_stride=kv_keep_stride, bq=bq, bk=bk, n_kv=k.shape[2])
    return torch.cat([_plain_rows(q[:, :, r0:r1], kp[:, :, :ke],
                                  vp[:, :, :ke], r0, **kw)
                      for r0, r1, ke in spans], dim=2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, kv_keep_stride: int = 1,
                    bq: int = 128, bk: int = 128):
    """q: (B,H,Sq,hd); k/v: (B,KVH,Skv,hd), H a multiple of KVH; returns
    (B,H,Sq,hd) in q's dtype. The kernel takes fp32 or bf16 (q, k, v of one
    dtype) and hd a multiple of 16 up to 256."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap, kv_keep_stride=kv_keep_stride,
                                     bq=bq, bk=bk)
    return _launch(q, k, v, causal, window, cap, kv_keep_stride, bq, bk)


def _launch(q, k, v, causal, window, cap, stride, bq, bk):
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: needs a CPU or CUDA tensor, "
                         f"got {dev}")
    if q.dim() != 4 or q.dtype not in _CODES:
        raise ValueError(f"flash_attention: q must be (B,H,Sq,hd) fp32 or "
                         f"bf16, got {q.dtype} {tuple(q.shape)}")
    B, H, Sq, hd = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (B, H, Sq, hd)),
                           ("k", k, (B, KVH, Skv, hd)),
                           ("v", v, (B, KVH, Skv, hd))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"flash_attention: {name} must be a contiguous {q.dtype} "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if hd % 16 or not 0 < hd <= _HD_MAX or KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: needs hd a multiple of 16 up to "
                         f"{_HD_MAX} and H a multiple of KVH; got hd={hd}, "
                         f"H={H}, KVH={KVH}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    bq, bk = _clip_blocks(Sq, Skv, bq, bk)
    design = select_flash_design(q.dtype, hd)
    lib = _build.load("flash_attention", _ARGTYPES)
    rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), B, H, KVH, Sq, Skv, hd, bq, bk,
                             int(causal), int(window), int(stride),
                             float(cap), float(hd ** -0.5), _CODES[q.dtype],
                             _DESIGNS[design],
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention: launch failed, cudaError {rc}")
    launches += 1
    design_launches[design] += 1
    return out


def flash_attention_backward(q, k, v, go, *, causal: bool = True,
                             window: int = 0, cap: float = 0.0,
                             kv_keep_stride: int = 1, bq: int = 128,
                             bk: int = 128):
    """Gradients of (q, k, v) for the cotangent ``go``: the VJP of
    ``flash_attention_plain``, recomputed under autograd one block of query
    rows at a time (dq per block, dk and dv summed over the blocks), each
    over the keys its rows can reach."""
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.promote_types(k.dtype,
                                                         torch.float32),
                     device=k.device)
    dv = torch.zeros_like(dk)
    with torch.enable_grad():
        kk = k.detach().requires_grad_(True)
        vv = v.detach().requires_grad_(True)
        bq, bk, kp, vp, spans = _row_walk(q.shape[2], kk, vv, causal=causal,
                                          bq=bq, bk=bk)
        kw = dict(causal=causal, window=window, cap=cap,
                  kv_keep_stride=kv_keep_stride, bq=bq, bk=bk,
                  n_kv=k.shape[2])
        for r0, r1, ke in spans:
            qs = q[:, :, r0:r1].detach().requires_grad_(True)
            o = _plain_rows(qs, kp[:, :, :ke], vp[:, :, :ke], r0, **kw)
            gq, gk, gv = torch.autograd.grad(o, (qs, kk, vv),
                                             go[:, :, r0:r1])
            dq[:, :, r0:r1] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` for autograd: the forward is the kernel (the
    plain version for CPU tensors), the backward
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, kv_keep_stride):
        ctx.kw = dict(causal=causal, window=window, cap=cap,
                      kv_keep_stride=kv_keep_stride)
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, go):
        grads = flash_attention_backward(*ctx.saved_tensors,
                                         go.contiguous(), **ctx.kw)
        return (*grads, None, None, None, None)
