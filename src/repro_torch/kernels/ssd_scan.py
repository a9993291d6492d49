"""Mamba2 chunked SSD scan: the CUDA kernels ``csrc/ssd_scan.cu``, forward
and backward, their plain PyTorch versions, and the autograd Function the
model calls.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``ssd_scan`` / ``_kernel``). For each (batch, head) the sequence runs in
chunks of Q; within a chunk ``la = dt·a``, ``cum = cumsum(la)``,
``total = cum[Q-1]``, ``u = dt·x``, ``G = C·Bᵀ`` and
``L_ti = exp(cum_t − cum_i)`` for i <= t (0 above the diagonal):

    y     = (G ∘ L)·u + exp(cum) ∘ (C·S_inᵀ)
    S_out = exp(total)·S_in + (exp(total − cum)·u)ᵀ·B

all in fp32 from a zero state, y cast to x's dtype. The Pallas grid walks
the chunks in order; here the scan runs as chunk-parallel passes, one
launch each (``FWD_PASSES``): (1) ``cum`` by a warp scan and G once per
(batch, chunk) for every head, B and C being one group; (2) each chunk's
local state ``(exp(total − cum)·u)ᵀ·B`` in parallel; (3) the state passing,
an elementwise walk over the chunks that turns the local states into the
states entering each chunk; (4) y. The serving path's calls (``init_state``,
``return_state``; ``ssd_scan_state`` pads any length to the kernels'
chunks) start pass 3 from the caller's state and write the state after the
last chunk out, the twin of ``ssd_chunked_ref(init_state=,
return_state=True)`` that the JAX package's prefill calls. The backward
(``BWD_PASSES``) is the closed chunked VJP of the same function
(``ssd_scan_backward_plain`` says it in PyTorch): passes 1-3 again, the
local state cotangents ``(exp(cum)·gy)ᵀ·C``, a reverse state pass for
the cotangent leaving each chunk, the head-summed ``L ∘ (gy·uᵀ)``, dx and
each row's decay terms per (batch, head, chunk), their reverse cumsum into
ddt, dB and dC as products summed over heads, and one ordered reduction of
the partial sums. No float atomics: the gradients on the card repeat from
run to run. Every product is a 64 x 64 tile of fp32 FMAs fed by
``cp.async`` chunks (the source says more).

``ssd_scan`` and ``ssd_scan_backward`` run the plain version for a CPU
tensor and launch the kernels for a CUDA tensor, raising on anything else;
they never fall back. ``SSDScan`` wraps them for autograd. The Pallas call
has no gradient; the JAX package differentiates ``ssd_chunked_ref`` on its
CPU path, whose gradient the closed form computes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0            # forward kernel launches since the last reset
backward_launches = 0   # backward kernel launches since the last reset

FWD_PASSES = 4          # launches of one forward call on the card
BWD_PASSES = 10         # launches of one backward call on the card
TILE = 64               # the kernels' output tile (rows x columns)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_Q_MAX = 128
_DG_BLOCKS, _DBC_BLOCKS = 8 * 132, 16 * 132
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGS = {
    "ssd_cum_g": [_P] * 7 + [_I] * 6 + [_P],
    "ssd_chunk_state": [_P] * 5 + [_I] * 8 + [_P],
    "ssd_state_pass": [_P] * 4 + [_I] * 7 + [_P],
    "ssd_out": [_P] * 7 + [_I] * 7 + [_P],
    "ssd_bwd_dg": [_P] * 5 + [_I] * 8 + [_P],
    "ssd_bwd_dx": [_P] * 13 + [_I] * 7 + [_P],
    "ssd_bwd_finish": [_P] * 7 + [_I] * 4 + [_P],
    "ssd_bwd_dbc": [_P] * 10 + [_I] * 10 + [_P],
    "ssd_bwd_reduce": [_P] * 5 + [_I] * 7 + [_P],
}


def _f32(x):
    return torch.promote_types(x.dtype, torch.float32)


def ssd_scan_plain(x, dt, a, b, c, *, chunk: int = 128, init_state=None,
                   return_state: bool = False):
    """What the Pallas ``_kernel`` computes, in plain PyTorch: chunk by
    chunk, every product and the carried state in fp32, only y cast to x's
    dtype (an fp64 input is computed in fp64, for gradient checks). Shapes
    and the state arguments as ``ssd_scan``."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    dev = x.device
    f32 = _f32(x)
    xh = x.to(f32).permute(0, 2, 1, 3)                     # (B,H,S,P)
    dth = dt.to(f32).permute(0, 2, 1)                      # (B,H,S)
    bf, cf, a = b.to(f32), c.to(f32), a.to(f32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    state = (torch.zeros((B, H, P, N), dtype=f32, device=dev)
             if init_state is None else init_state.to(f32))
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
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype)
    return (y, state) if return_state else y


class _Chunks:
    """Passes 1-3 of the kernels in plain PyTorch, chunks side by side:
    per (batch, chunk) the chunk's inputs in fp32 (fp64 stays fp64) and
    ``cum``, ``L`` (B,nc,Q,Q,H: t, i, head, exp taken of kept entries
    only), ``G`` (B,nc,Q,Q), ``u = dt·x`` and ``s_in``, the state entering
    each chunk (B,nc,H,P,N), from ``init_state`` (B,H,P,N) or zero, and
    ``s_out``, the state after the last chunk (B,H,P,N)."""

    def __init__(self, x, dt, a, b, c, chunk, init_state=None):
        B, S, H, P = x.shape
        N = b.shape[-1]
        Q = min(chunk, S)
        assert S % Q == 0, (S, Q)
        nc = S // Q
        f = _f32(x)
        self.shape = (B, S, H, P, N, Q, nc)
        self.x = x.to(f).reshape(B, nc, Q, H, P)
        self.dt = dt.to(f).reshape(B, nc, Q, H)
        self.a = a.to(f)
        self.b = b.to(f).reshape(B, nc, Q, N)
        self.c = c.to(f).reshape(B, nc, Q, N)
        # pass 1: the decay and C·Bᵀ, once for every head
        self.cum = torch.cumsum(self.dt * self.a, dim=2)          # (B,nc,Q,H)
        self.total = self.cum[:, :, -1]                           # (B,nc,H)
        self.g = torch.einsum("bctn,bcin->bcti", self.c, self.b)
        tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                    device=x.device))[None, None, :, :, None]
        dec = self.cum[:, :, :, None, :] - self.cum[:, :, None, :, :]
        zero = torch.zeros((), dtype=f, device=x.device)
        self.L = torch.where(tri, torch.exp(torch.where(tri, dec, zero)),
                             zero)
        self.u = self.dt[..., None] * self.x                     # (B,nc,Q,H,P)
        self.wdec = torch.exp(self.total[:, :, None] - self.cum)  # (B,nc,Q,H)
        # pass 2: each chunk's own state; pass 3: the states entering
        s_loc = torch.einsum("bcih,bcihp,bcin->bchpn", self.wdec, self.u,
                             self.b)
        self.s_in = _state_pass(s_loc, self.total, reverse=False,
                                init=init_state)
        self.s_out = self.s_in[:, -1] * torch.exp(
            self.total[:, -1])[..., None, None] + s_loc[:, -1]


def _state_pass(loc, total, reverse, init=None):
    """Pass 3 and its reverse: ``out[c] = run`` before chunk c is folded
    in, ``run = exp(total[c])·run + loc[c]``, over c in order (the state
    entering each chunk) or in reverse (the cotangent leaving each chunk),
    ``run`` starting from ``init`` or zero."""
    nc = loc.shape[1]
    run = (torch.zeros_like(loc[:, 0]) if init is None
           else init.to(loc.dtype))
    out = [None] * nc
    for c in (reversed(range(nc)) if reverse else range(nc)):
        out[c] = run
        run = run * torch.exp(total[:, c])[..., None, None] + loc[:, c]
    return torch.stack(out, dim=1)


def ssd_passes_plain(x, dt, a, b, c, *, chunk: int = 128, init_state=None,
                     return_state: bool = False):
    """The forward as the kernels run it, passes 1-4 in plain PyTorch: the
    same function as ``ssd_scan_plain``, summed in the passes' order."""
    k = _Chunks(x, dt, a, b, c, chunk, init_state)
    B, S, H, P, N, Q, nc = k.shape
    y = torch.einsum("bcti,bctih,bcihp->bcthp", k.g, k.L, k.u) \
        + torch.exp(k.cum)[..., None] \
        * torch.einsum("bctn,bchpn->bcthp", k.c, k.s_in)
    y = y.reshape(B, S, H, P).to(x.dtype)
    return (y, k.s_out) if return_state else y


def ssd_scan_backward_plain(x, dt, a, b, c, gy, *, chunk: int = 128):
    """Gradients of (x, dt, a, b, c) of ``ssd_scan`` for the cotangent
    ``gy``, in the closed chunked form the backward kernels compute. Per
    (batch, head, chunk), with dS_out the cotangent of the state leaving
    the chunk (0 for the last):

        dS_in = exp(total)·dS_out + Σ_t exp(cum_t)·gy_t·C_tᵀ
        du_i  = Σ_{t>=i} G_ti·L_ti·gy_t + exp(total − cum_i)·dS_out·B_i
        dG    = L ∘ (gy·uᵀ), summed over heads into dB and dC with the
                state terms exp(cum_t)·S_inᵀ·gy_t and
                exp(total − cum_i)·dS_outᵀ·u_i
        dcum_t = Σ_i M_ti − Σ_t' M_t't + exp(cum_t)·gy_t·(S_in·C_t) − R_t,
                 M = G ∘ dG, R_i = exp(total − cum_i)·u_iᵀ·dS_out·B_i,
                 and dcum_{Q-1} += Σ_i R_i + exp(total)·<dS_out, S_in>

    then dla = the reverse cumsum of dcum, dx = dt·du, ddt = x·du + a·dla,
    da = Σ dt·dla. fp32 (fp64 stays fp64); x, b and c's gradients in their
    dtypes."""
    k = _Chunks(x, dt, a, b, c, chunk)
    B, S, H, P, N, Q, nc = k.shape
    gy = gy.to(k.x.dtype).reshape(B, nc, Q, H, P)
    ecum = torch.exp(k.cum)
    ds_loc = torch.einsum("bcth,bcthp,bctn->bchpn", ecum, gy, k.c)
    ds_out = _state_pass(ds_loc, k.total, reverse=True)
    gl = k.g[..., None] * k.L                                  # (B,nc,Q,Q,H)
    w = torch.einsum("bcin,bchpn->bcihp", k.b, ds_out)
    du = torch.einsum("bctih,bcthp->bcihp", gl, gy) + k.wdec[..., None] * w
    dg = k.L * torch.einsum("bcthp,bcihp->bctih", gy, k.u)
    dg_sum = dg.sum(-1)
    dc = torch.einsum("bcti,bcin->bctn", dg_sum, k.b) + torch.einsum(
        "bcth,bcthp,bchpn->bctn", ecum, gy, k.s_in)
    db = torch.einsum("bcti,bctn->bcin", dg_sum, k.c) + torch.einsum(
        "bcih,bcihp,bchpn->bcin", k.wdec, k.u, ds_out)
    m = k.g[..., None] * dg
    r = k.wdec * (k.u * w).sum(-1)                            # (B,nc,Q,H)
    dcum = m.sum(3) - m.sum(2) - r + ecum * (gy * torch.einsum(
        "bctn,bchpn->bcthp", k.c, k.s_in)).sum(-1)
    dcum[:, :, -1] += r.sum(2) + torch.exp(k.total) * (
        ds_out * k.s_in).sum((-1, -2))
    dla = dcum.flip(2).cumsum(2).flip(2)
    ddt = (k.x * du).sum(-1) + k.a * dla
    da = (k.dt * dla).sum((0, 1, 2))
    dx = k.dt[..., None] * du
    return (dx.reshape(B, S, H, P).to(x.dtype), ddt.reshape(B, S, H),
            da, db.reshape(B, S, N).to(b.dtype),
            dc.reshape(B, S, N).to(c.dtype))


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, init_state=None,
             return_state: bool = False):
    """x: (B,S,H,P); dt: (B,S,H) fp32 (already softplus'd); a: (H,) fp32,
    negative; b, c: (B,S,N) in x's dtype (one group, broadcast over heads).
    Returns y (B,S,H,P) in x's dtype, without the D-skip (the caller adds
    it, as ``ops.ssd`` does). ``init_state`` (B,H,P,N) fp32 seeds the
    recurrence in place of zero; with ``return_state`` the call returns
    (y, the (B,H,P,N) fp32 state after the last token), the serving path's
    handoff (forward only: ``SSDScan`` never passes a state)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, chunk=chunk,
                              init_state=init_state,
                              return_state=return_state)
    return _launch(x, dt, a, b, c, chunk, init_state, return_state)


def state_chunk(S: int, chunk: int):
    """(Q, S_pad) of a call with a state: the chunk length the kernel runs
    ``S`` tokens at, and ``S`` padded up to a multiple of it. ``chunk`` is
    rounded down to a multiple of 4 within [4, 128]; a shorter sequence is
    one chunk of its length rounded up to a multiple of 4. The JAX
    package's ``mamba_prefill`` chunks at the largest divisor of S that is
    at most ``chunk`` (1 for a prime S), which the kernel's tiles refuse."""
    q = max(4, min(chunk, _Q_MAX) // 4 * 4)
    if S <= q:
        q = max(4, -(-S // 4) * 4)
    return q, -(-S // q) * q


def ssd_scan_state(x, dt, a, b, c, *, chunk: int = 128, init_state=None):
    """``ssd_scan`` from ``init_state`` (or zero) with the final state out,
    at any length S: the tokens are padded at the end to ``state_chunk``'s
    length with x = 0, dt = 0 and b = c = 0. A padded token decays the
    state by exp(0) = 1 and adds nothing to it, so the final state and
    every real token's y are those of the unpadded sequence (chunked
    otherwise, so equal within fp32 rounding). Returns (y (B,S,H,P), state
    (B,H,P,N) fp32)."""
    S = x.shape[1]
    Q, S_pad = state_chunk(S, chunk)
    if S_pad != S:
        pad = S_pad - S
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    y, state = ssd_scan(x, dt, a, b, c, chunk=Q, init_state=init_state,
                        return_state=True)
    return y[:, :S], state


def ssd_scan_backward(x, dt, a, b, c, gy, *, chunk: int = 128):
    """Gradients of (x, dt, a, b, c) for the cotangent ``gy``: the plain
    closed form for a CPU tensor, the backward kernels for a CUDA one."""
    if x.device.type == "cpu":
        return ssd_scan_backward_plain(x, dt, a, b, c, gy, chunk=chunk)
    return _launch_backward(x, dt, a, b, c, gy, chunk)


def _check(x, dt, a, b, c, chunk, gy=None):
    """The kernels' limits; returns (B, S, H, P, N, Q)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: needs a CPU or CUDA tensor, got {dev}")
    if x.dim() != 4 or x.dtype not in _CODES:
        raise ValueError(f"ssd_scan: x must be (B,S,H,P) fp32 or bf16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    ts = [("x", x, x.dtype, (B, S, H, P)), ("dt", dt, torch.float32,
                                            (B, S, H)),
          ("a", a, torch.float32, (H,)), ("b", b, x.dtype, (B, S, N)),
          ("c", c, x.dtype, (B, S, N))]
    if gy is not None:
        ts.append(("gy", gy, x.dtype, (B, S, H, P)))
    for name, t, dtype, shape in ts:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"ssd_scan: {name} must be a contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if Q < 4 or S % Q or Q % 4 or Q > _Q_MAX or P % 4 or N % 4:
        raise ValueError(
            f"ssd_scan: needs S % Q == 0, Q % 4 == 0, 4 <= Q <= {_Q_MAX}, "
            f"P % 4 == 0 and N % 4 == 0; got S={S}, Q={Q}, P={P}, N={N}")
    return B, S, H, P, N, Q


def splits(B, nc, H, Q, N):
    """How the backward spreads the head sums over blocks, from shapes
    alone: ``(heads_per_group, n_groups)`` of the dG pass, whose blocks
    each sum L ∘ (gy·uᵀ) over one group's heads, and ``(heads_per_split,
    n_splits)`` of the dB/dC pass, whose blocks each sum one split's heads
    (one more split takes the head-summed dG). They aim at ~8 and ~16
    blocks an SM of an H100's 132; the partial sums are added in a fixed
    order."""
    nt = -(-Q // TILE)
    base = nt * (nt + 1) // 2 * B * nc
    hpg = -(-H // min(H, -(-_DG_BLOCKS // base)))
    base = 2 * nt * -(-N // TILE) * B * nc
    hps = -(-H // min(H, -(-_DBC_BLOCKS // base)))
    return hpg, -(-H // hpg), hps, -(-H // hps)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _call(lib, name, *args):
    rc = getattr(lib, name)(*args)
    if rc:      # 1 (invalid value): a shape the kernel refuses
        raise RuntimeError(f"ssd_scan: {name} launch failed, cudaError {rc}")


def _lib():
    for name, sig in _SIGS.items():
        lib = _build.load("ssd_scan", sig, name)
    return lib


def _prologue(lib, x, dt, a, b, c, shape, code, st, init=None, fin=None):
    """Passes 1-3: returns (cum, G, Gᵀ, S_in); adds 3 to the caller's
    count of launches. ``init`` / ``fin``: (B,H,N,P) fp32, the state
    entering chunk 0 and the buffer for the final state, or None."""
    B, S, H, P, N, Q = shape
    nc = S // Q
    f32 = dict(device=x.device, dtype=torch.float32)
    cum = torch.empty((B, H, S), **f32)
    g = torch.empty((B, nc, Q, Q), **f32)
    gt = torch.empty((B, nc, Q, Q), **f32)
    s = torch.empty((B, nc, H, N, P), **f32)
    _call(lib, "ssd_cum_g", dt.data_ptr(), a.data_ptr(), b.data_ptr(),
          c.data_ptr(), cum.data_ptr(), g.data_ptr(), gt.data_ptr(),
          B, S, H, N, Q, code, st)
    _call(lib, "ssd_chunk_state", x.data_ptr(), b.data_ptr(),
          dt.data_ptr(), cum.data_ptr(), s.data_ptr(),
          B, S, H, P, N, Q, 0, code, st)
    _call(lib, "ssd_state_pass", s.data_ptr(), cum.data_ptr(),
          None if init is None else init.data_ptr(),
          None if fin is None else fin.data_ptr(), B, S, H, P, N, Q, 0, st)
    return cum, g, gt, s


def _launch(x, dt, a, b, c, chunk, init_state=None, return_state=False):
    """The forward passes. The state arguments cross the boundary
    transposed: the kernels keep a state as (N, P) a (batch, head), the
    callers as (P, N)."""
    global launches
    shape = _check(x, dt, a, b, c, chunk)
    B, S, H, P, N, Q = shape
    f32 = dict(device=x.device, dtype=torch.float32)
    init = fin = None
    if init_state is not None:
        if tuple(init_state.shape) != (B, H, P, N) or \
                init_state.dtype != torch.float32 or \
                init_state.device != x.device:
            raise ValueError(
                f"ssd_scan: init_state must be fp32 {(B, H, P, N)} on "
                f"{x.device}, got {init_state.dtype} "
                f"{tuple(init_state.shape)} on {init_state.device}")
        init = init_state.transpose(-1, -2).contiguous()
    if return_state:
        fin = torch.empty((B, H, N, P), **f32)
    y = torch.empty_like(x)
    if y.numel() == 0 and not return_state:
        return y
    lib, code, st = _lib(), _CODES[x.dtype], _stream(x.device)
    cum, g, _, s = _prologue(lib, x, dt, a, b, c, shape, code, st, init,
                             fin)
    launches += 3
    _call(lib, "ssd_out", x.data_ptr(), dt.data_ptr(), c.data_ptr(),
          cum.data_ptr(), g.data_ptr(), s.data_ptr(), y.data_ptr(),
          B, S, H, P, N, Q, code, st)
    launches += 1
    return (y, fin.transpose(-1, -2)) if return_state else y


def _launch_backward(x, dt, a, b, c, gy, chunk):
    global backward_launches
    shape = _check(x, dt, a, b, c, chunk, gy)
    B, S, H, P, N, Q = shape
    nc = S // Q
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty_like(a)
    if x.numel() == 0 or b.numel() == 0:
        return dx.zero_(), ddt.zero_(), da.zero_(), db.zero_(), dc.zero_()
    lib, code, st = _lib(), _CODES[x.dtype], _stream(x.device)
    cum, g, gt, s = _prologue(lib, x, dt, a, b, c, shape, code, st)
    backward_launches += 3
    f32 = dict(device=x.device, dtype=torch.float32)
    ds = torch.empty((B, nc, H, N, P), **f32)
    _call(lib, "ssd_chunk_state", gy.data_ptr(), c.data_ptr(),
          dt.data_ptr(), cum.data_ptr(), ds.data_ptr(),
          B, S, H, P, N, Q, 1, code, st)
    backward_launches += 1
    _call(lib, "ssd_state_pass", ds.data_ptr(), cum.data_ptr(), None, None,
          B, S, H, P, N, Q, 1, st)
    backward_launches += 1
    hpg, n_groups, hps, n_splits = splits(B, nc, H, Q, N)
    dgp = torch.empty((2, B, nc, n_groups, Q, Q), **f32)
    _call(lib, "ssd_bwd_dg", gy.data_ptr(), x.data_ptr(), dt.data_ptr(),
          cum.data_ptr(), dgp.data_ptr(), B, S, H, P, Q, hpg, n_groups,
          code, st)
    backward_launches += 1
    rows = torch.empty((3, B, H, S), **f32)
    dss = torch.empty((B, nc, H), **f32)
    _call(lib, "ssd_bwd_dx", x.data_ptr(), dt.data_ptr(), b.data_ptr(),
          c.data_ptr(), gy.data_ptr(), cum.data_ptr(), g.data_ptr(),
          gt.data_ptr(), s.data_ptr(), ds.data_ptr(), dx.data_ptr(),
          rows.data_ptr(), dss.data_ptr(), B, S, H, P, N, Q, code, st)
    backward_launches += 1
    dapart = torch.empty((B, nc, H), **f32)
    _call(lib, "ssd_bwd_finish", rows.data_ptr(), dss.data_ptr(),
          dt.data_ptr(), a.data_ptr(), cum.data_ptr(), ddt.data_ptr(),
          dapart.data_ptr(), B, S, H, Q, st)
    backward_launches += 1
    part = torch.empty((2, B, nc, n_splits + 1, Q, N), **f32)
    _call(lib, "ssd_bwd_dbc", x.data_ptr(), dt.data_ptr(), b.data_ptr(),
          c.data_ptr(), gy.data_ptr(), cum.data_ptr(), s.data_ptr(),
          ds.data_ptr(), dgp.data_ptr(), part.data_ptr(),
          B, S, H, P, N, Q, n_groups, hps, n_splits, code, st)
    backward_launches += 1
    _call(lib, "ssd_bwd_reduce", part.data_ptr(), dapart.data_ptr(),
          db.data_ptr(), dc.data_ptr(), da.data_ptr(),
          B, S, H, N, Q, n_splits, code, st)
    backward_launches += 1
    return dx, ddt, da, db, dc


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` for autograd: the forward kernels (the plain version
    for CPU tensors), the backward ``ssd_scan_backward``."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c)
        return ssd_scan(x, dt, a, b, c, chunk=chunk)

    @staticmethod
    def backward(ctx, gy):
        grads = ssd_scan_backward(*ctx.saved_tensors, gy.contiguous(),
                                  chunk=ctx.chunk)
        return (*grads, None)
