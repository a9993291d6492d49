"""Mamba2 chunked SSD scan: the CUDA kernel ``csrc/ssd_scan.cu``, its plain
PyTorch version, and the autograd Function the model calls.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan`` / ``_kernel``). For each (batch, head) the sequence runs in
chunks of Q, in order; within a chunk ``la = dt·a``, ``cum = cumsum(la)`` and

    y = tril(C·Bᵀ ∘ exp(cum_t − cum_i)) @ (dt·x) + exp(cum) ∘ (C·Sᵀ)
    S ← exp(total)·S + (exp(total − cum)·dt·x)ᵀ·B

all in fp32, y cast to x's dtype. On the H100 it is bound by fp32
operations (~5.3 MFLOP per (batch, head, chunk) of Q=128, N=128, P=64, plus
~2.1 MFLOP of C·Bᵀ per (batch, chunk) shared by the heads, against ~2 KB per
row of I/O): the Pallas grid's sequential chunk axis becomes a loop inside
the block with the state in shared memory, the head dimension P is split
across blocks (a row of the state touches only its column of x and y), so
(batch, head, P-tile) blocks fill the card at the price of rebuilding C·Bᵀ
in each, and the Q×Q decay-weighted C·Bᵀ is built in 32-row strips, lower
triangle only, to fit the 227 KB of shared memory (see the source for the
layout).

``ssd_scan`` runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, raising on anything else; it never falls back. ``SSDScan``
wraps it for autograd. There is no backward kernel on either chip (the
Pallas call has no JVP rule): ``ssd_scan_backward`` is the VJP of
``ref.ssd_chunked_ref``, the function the JAX package differentiates on its
CPU path, recomputed under autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0          # kernel launches since the last reset (plain runs: 0)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_Q_MAX, _N_MAX = 128, 256


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int = 128):
    """What the kernel (and the Pallas ``_kernel``) computes, in plain
    PyTorch: chunk by chunk, every product and the carried state in fp32,
    only y cast to x's dtype (an fp64 input is computed in fp64, for
    gradient checks). Shapes as ``ssd_scan``."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    dev = x.device
    f32 = torch.promote_types(x.dtype, torch.float32)
    xh = x.to(f32).permute(0, 2, 1, 3)                     # (B,H,S,P)
    dth = dt.to(f32).permute(0, 2, 1)                      # (B,H,S)
    bf, cf, a = b.to(f32), c.to(f32), a.to(f32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    state = torch.zeros((B, H, P, N), dtype=f32, device=dev)
    ys = []
    for s0 in range(0, S, Q):
        xq = xh[:, :, s0:s0 + Q]                           # (B,H,Q,P)
        dq = dth[:, :, s0:s0 + Q]                          # (B,H,Q)
        bq, cq = bf[:, None, s0:s0 + Q], cf[:, None, s0:s0 + Q]  # (B,1,Q,N)
        cum = torch.cumsum(dq * a[None, :, None], dim=-1)
        total = cum[..., -1:]
        g = cq @ bq.transpose(-1, -2)                      # (B,1,Q,Q)
        w = torch.where(tri, g * torch.exp(cum[..., :, None]
                                           - cum[..., None, :]), 0.0)
        y = w @ (dq[..., None] * xq)
        y = y + torch.exp(cum)[..., None] * (cq @ state.transpose(-1, -2))
        ys.append(y)
        wi = (torch.exp(total - cum) * dq)[..., None]      # (B,H,Q,1)
        state = state * torch.exp(total)[..., None] \
            + (wi * xq).transpose(-1, -2) @ bq
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H) fp32 (already softplus'd); a: (H,) fp32,
    negative; b, c: (B,S,N) in x's dtype (one group, broadcast over heads).
    Returns y (B,S,H,P) in x's dtype, without the D-skip (the caller adds
    it, as ``ops.ssd`` does)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
    return _launch(x, dt, a, b, c, chunk)


def _launch(x, dt, a, b, c, chunk):
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: needs a CPU or CUDA tensor, got {dev}")
    if x.dim() != 4 or x.dtype not in _CODES:
        raise ValueError(f"ssd_scan: x must be (B,S,H,P) fp32 or bf16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    for name, t, dtype, shape in (("x", x, x.dtype, (B, S, H, P)),
                                  ("dt", dt, torch.float32, (B, S, H)),
                                  ("a", a, torch.float32, (H,)),
                                  ("b", b, x.dtype, (B, S, N)),
                                  ("c", c, x.dtype, (B, S, N))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"ssd_scan: {name} must be a contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if S % Q or Q % 4 or Q > _Q_MAX or N > _N_MAX or N & (N - 1):
        raise ValueError(
            f"ssd_scan: needs S % Q == 0, Q % 4 == 0, Q <= {_Q_MAX} and N a "
            f"power of two <= {_N_MAX}; got S={S}, Q={Q}, N={N}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.load("ssd_scan", _ARGTYPES)
    rc = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                      b.data_ptr(), c.data_ptr(), y.data_ptr(),
                      B, S, H, P, N, Q, _CODES[x.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc:      # 1 (invalid value): the tiles of Q, N need > 227 KB
        raise RuntimeError(f"ssd_scan: launch failed, cudaError {rc}")
    launches += 1
    return y


def ssd_scan_backward(x, dt, a, b, c, gy, *, chunk: int = 128):
    """Gradients of (x, dt, a, b, c) for the cotangent ``gy``: the VJP of
    ``ref.ssd_chunked_ref`` (without D-skip), recomputed under autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, a, b, c)]
        y = ref.ssd_chunked_ref(*ins, chunk=chunk)
        return torch.autograd.grad(y, ins, gy)


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` for autograd: the forward is the kernel (the plain
    version for CPU tensors), the backward ``ssd_scan_backward``."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c)
        return ssd_scan(x, dt, a, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        grads = ssd_scan_backward(*ctx.saved_tensors, gy, chunk=ctx.chunk)
        return (*grads, None)
