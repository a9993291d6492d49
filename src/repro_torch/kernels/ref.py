"""Plain PyTorch oracles: the counterparts of the JAX package's
``kernels/ref.py`` for the W8A8 matmul (``quantize_rowwise``,
``int8_matmul_ref``, ``quantized_matmul_ref``), masked attention
(``mha_ref``) and the Mamba2 SSD (``ssd_ref``, ``ssd_chunked_ref``). The
kernels' own plain versions sit beside their wrappers
(``kernels/paged_attention.py``, ``kernels/flash_attention.py``,
``kernels/ssd_scan.py``)."""
from __future__ import annotations

import torch


def quantize_rowwise(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization with per-row (``axis``-reduced) fp32
    scales. ``torch.round`` rounds half to even, as ``jnp.round`` does.
    The divisor 127 is a tensor on x's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which can round the scale
    one ulp away from the true quotient the CPU and the JAX package take."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_ref(x_q, x_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """x_q: (M,K) int8, x_scale: (M,1) f32; w_q: (K,N) int8, w_scale: (1,N);
    or a stack of E such products, each with a leading (E,) dimension.

    The integer product is taken in float64, which holds every int8 x int8
    sum of up to 2^37 terms exactly, so this is the exact int32 accumulate
    on any device (CUDA has no int32 matmul); ``float(acc) * x_scale *
    w_scale`` then rounds exactly as the JAX reference does."""
    acc = x_q.double() @ w_q.double()
    return (acc.float() * x_scale * w_scale).to(out_dtype)


def quantized_matmul_ref(x, w, out_dtype=None):
    """End-to-end W8A8 dynamic-quantized matmul (arbitrary leading dims)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x_q, x_s = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    w_q, w_s = quantize_rowwise(w, axis=0)
    y = int8_matmul_ref(x_q, x_s, w_q, w_s, out_dtype)
    return y.reshape(lead + (w.shape[-1],))


# ------------------------------------------------------- flash attention ----

def mha_ref(q, k, v, *, causal=True, window=0, cap=0.0):
    """Naive masked attention oracle. q: (B,H,Sq,hd), k/v: (B,KVH,Skv,hd).

    GQA: q head h reads kv head h // (H // KVH). Query positions are
    END-aligned with the keys (``qp = arange(Sq) + Skv - Sq``, the decode
    convention); masked scores sit at -1e30 and the softmax is fp32, ``p``
    cast to q's dtype before P.V."""
    Sq, hd = q.shape[2], q.shape[3]
    Skv = k.shape[2]
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    f32 = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f32), k.to(f32)) * hd ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    qp = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


# ---------------------------------------------------------- Mamba2 SSD ----

def ssd_ref(x, dt, a, b, c, *, d_skip=None):
    """Naive per-token SSD recurrence oracle (fp32 state).

    x: (B,S,H,P); dt: (B,S,H) (already softplus'd); a: (H,) negative;
    b, c: (B,S,N) (single group, broadcast over heads). Returns (B,S,H,P).
    """
    Bsz, S, H, P = x.shape
    N = b.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf = b.float(), c.float()
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * a)                            # (B,H)
        state = (state * da[..., None, None]
                 + (dtf[:, t, :, None] * xf[:, t])[..., None]
                 * bf[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cf[:, t]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunked_ref(x, dt, a, b, c, *, chunk=64, d_skip=None,
                    return_state=False, init_state=None):
    """Chunked (state-space-duality) SSD: the algorithm the kernel
    implements, with the JAX function's casts. The rank-5 intra-chunk
    operands are cast to the INPUT dtype before their products; cumsum, the
    chunk-state recurrence and every product's accumulator stay fp32 (a
    low-precision operand is upcast exactly before an fp32 einsum, which is
    what ``preferred_element_type=float32`` computes). An fp64 input is
    computed in fp64 throughout (for gradient checks).

    ``return_state=True`` also returns the final (B,H,P,N) fp32 state;
    ``init_state`` seeds the recurrence with an existing (B,H,P,N) state."""
    Bsz, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    f32 = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(f32).reshape(Bsz, nc, Q, H, P)
    dtf = dt.to(f32).reshape(Bsz, nc, Q, H)
    bf = b.to(f32).reshape(Bsz, nc, Q, N)
    cf = c.to(f32).reshape(Bsz, nc, Q, N)
    la = dtf * a                                     # (B,nc,Q,H) log-decay
    cum = torch.cumsum(la, dim=2)                    # inclusive
    total = cum[:, :, -1:, :]                        # (B,nc,1,H)
    cdt = x.dtype

    def low(t):                  # round to the input dtype, compute in fp32
        return t.to(cdt).to(f32)

    g = torch.einsum("bcqn,bckn->bcqk", cf, bf)      # (B,nc,Q,Q)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H) t,i
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device)
                      )[None, None, :, :, None]
    zero = torch.zeros((), dtype=dec.dtype, device=x.device)
    # exp only of the kept (t >= i, dec <= 0) entries: the same values as
    # the JAX function's where(mask, exp(dec), 0), whose masked exp(dec > 88)
    # overflows fp32 and turns its gradient into 0 * inf = NaN
    m = torch.where(mask, torch.exp(torch.where(mask, dec, zero)), zero)
    w = low(g[..., None] * m * dtf[:, :, None, :, :])
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w, low(xf))
    wi = torch.exp(total - cum) * dtf                # (B,nc,Q,H)
    s_in = torch.einsum("bcqhp,bcqn->bchpn", low(xf * wi[..., None]),
                        low(bf))
    decay = torch.exp(total[:, :, 0, :])             # (B,nc,H)
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    enters = []
    for ci in range(nc):
        enters.append(s)
        s = s * decay[:, ci, :, None, None] + s_in[:, ci]
    s_enter = torch.stack(enters, dim=1)             # (B,nc,H,P,N)
    y_state = torch.einsum("bcqn,bchpn->bcqhp", low(cf), low(s_enter)) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_state).reshape(Bsz, S, H, P)
    if d_skip is not None:
        y = y + d_skip.to(f32)[None, None, :, None] * x.to(f32)
    if return_state:
        return y.to(x.dtype), s
    return y.to(x.dtype)
