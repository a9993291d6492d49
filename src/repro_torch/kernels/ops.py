"""Public entry points of the kernels, dispatched on the tensor's device.

Counterpart of the JAX package's ``kernels/ops.py``: a CUDA tensor launches
the hand-written kernel (or raises), a CPU tensor takes the kernel's plain
version. There is no switch beyond the device. ``quantized_matmul``,
``flash`` and ``ssd`` are differentiable (the training path); their
backward rules follow what ``jax.grad`` does with the JAX package's CPU
path. ``flash`` follows the Pallas kernel on both devices (start-aligned
positions, ``kv_keep_stride`` honoured), where the JAX package's CPU branch
falls back to the end-aligned ``mha_ref`` and drops the stride.
"""
from __future__ import annotations

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.int8_matmul import int8_matmul_t
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.quantize_rows import (quantize_rows,
                                               quantize_rows_backward)
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_state


def int8_acc(x_q, w_t):
    """The exact int32 sums of ``x_q @ w_t.T`` as fp32 (``acc.astype(f32)``
    in the JAX reference): ``int8_matmul_t`` with unit scales and an fp32
    output."""
    return int8_matmul_t(x_q, None, w_t, None, out_dtype=torch.float32)


def _quantize_x(x):
    """The rows of x (..., M, K) quantised in one ``quantize_rows`` launch:
    int8 in x's shape and fp32 scales (..., M, 1)."""
    q, s = quantize_rows(x.reshape(-1, x.shape[-1]).contiguous())
    return q.view(x.shape), s.view(x.shape[:-1] + (1,))


class _QuantizedMatmul(torch.autograd.Function):
    """W8A8 product of x (M, K) and w (K, N), or of E experts' stacks x (E,
    M, K) and w (E, K, N), for autograd: both quantised (``quantize_rows``,
    the weight as rows of its transpose, each operand in one launch),
    multiplied by ``int8_matmul_t`` (a stack in one launch). With ``out =
    (acc * x_s) * w_s`` the gradient reaches only the scales, as under
    ``jax.grad`` of ``quantized_matmul_ref`` (of its ``jax.vmap`` for a
    stack): ``d x_s = sum_n (g * w_s) * acc`` and ``d w_s = sum_m g * (acc
    * x_s)``, the exact int32 sums ``acc`` taken again by one kernel launch;
    from the scales ``quantize_rows_backward`` carries them to the rows of
    x and of w's transpose, one launch each."""

    @staticmethod
    def forward(ctx, x, w):
        x_q, x_s = _quantize_x(x)
        w_t, w_s = quantize_weight(w)
        ctx.save_for_backward(x, w, x_q, x_s, w_t, w_s)
        return int8_matmul_t(x_q, x_s, w_t, w_s, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, x_q, x_s, w_t, w_s = ctx.saved_tensors
        K = x.shape[-1]
        acc = int8_acc(x_q, w_t)                        # (..., M, N) fp32
        g = g.float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            d_xs = ((g * w_s.transpose(-1, -2)) * acc).sum(-1, keepdim=True)
            gx = quantize_rows_backward(x.reshape(-1, K).contiguous(),
                                        d_xs.reshape(-1, 1)).view(x.shape)
        if ctx.needs_input_grad[1]:
            d_ws = (g * (acc * x_s)).sum(-2)              # (..., N)
            w_r = w.transpose(-1, -2)
            gw = quantize_rows_backward(w_r.reshape(-1, K).contiguous(),
                                        d_ws.reshape(-1, 1)
                                        ).view(w_r.shape).transpose(-1, -2)
        return gx, gw


# (w_t, w_s) of the weights that serve without autograd, keyed on the
# weight's storage, offset, shape, strides and dtype; an entry holds the
# version counter it was made at, so an in-place update (a view shares its
# base's counter) misses. The key's weak reference to the storage keeps a
# dead storage's identity (the key's hash) from passing to a new one while
# the entry exists.
_weight_cache: dict = {}
# quantisations made by ``cached_weight`` (a capture asserts it made none),
# and a count of the times a cached int8 weight was dropped: a CUDA graph
# holds the addresses of the entries it read, so a change of the count
# retires it
weight_cache_misses = 0
weight_cache_drops = 0


def quantize_weight(w):
    """``(w_t, w_s)`` of a (K, N) weight: int8 (N, K), K-major, and fp32
    (N, 1), the rows of ``w.t()`` quantised. That takes the same amax over
    the same entries and the same fp32 division as the JAX package's
    ``quantize_rowwise(w, axis=0)``, so it is that bit for bit, transposed.
    A stack of E experts' weights (E, K, N) gives (E, N, K) and (E, N, 1)
    from one ``quantize_rows`` over the (E·N, K) rows of
    ``w.transpose(1, 2)``: per (expert, column), as ``quantize_rowwise(w_e,
    axis=0)`` under ``jax.vmap``."""
    if w.dim() == 3:
        E, K, N = w.shape
        q, s = quantize_rows(w.transpose(1, 2).reshape(E * N, K))
        return q.view(E, N, K), s.view(E, N, 1)
    return quantize_rows(w.t().contiguous())


def cached_weight(w):
    """``quantize_weight(w)``, made once for as long as ``w`` is unchanged."""
    global weight_cache_misses, weight_cache_drops
    key = (StorageWeakRef(w.untyped_storage()), w.storage_offset(),
           tuple(w.shape), w.stride(), w.dtype)
    hit = _weight_cache.get(key)
    if hit is not None and hit[0] == w._version:
        return hit[1], hit[2]
    if hit is None:     # a new weight: drop the entries of dead ones
        dead = [k for k in _weight_cache if k[0].expired()]
        for k in dead:
            del _weight_cache[k]
        weight_cache_drops += len(dead)
    else:
        weight_cache_drops += 1
    weight_cache_misses += 1
    w_t, w_s = quantize_weight(w)
    _weight_cache[key] = (w._version, w_t, w_s)
    return w_t, w_s


def clear_weight_cache():
    """Drop every cached int8 weight (a swap away from the int8 rungs)."""
    global weight_cache_drops
    weight_cache_drops += len(_weight_cache)
    _weight_cache.clear()


def quantized_matmul(x, w):
    """W8A8 dynamic-quantized matmul (the Pliant lower-precision knob), as
    the JAX package computes it: x per row on every call, w (K, N) per
    column, multiplied by ``int8_matmul_t``. Without autograd (serving) the
    weight is quantised once while it is unchanged (``cached_weight``);
    when autograd needs the graph (training) every call quantises both
    through ``_QuantizedMatmul``, whose backward carries the scales'
    gradient as autograd would through ``quantize_rowwise``.

    A stack of experts, x (E, M, K) with w (E, K, N), is E products in one
    ``quantize_rows`` launch over x's (E·M, K) rows and one ``int8_matmul``
    launch (the JAX package's ``jax.vmap`` of ``quantized_matmul``)."""
    x2 = x if w.dim() == 3 else x.reshape(-1, x.shape[-1]).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _QuantizedMatmul.apply(x2, w)
    else:
        x_q, x_s = _quantize_x(x2)
        w_t, w_s = cached_weight(w)
        y = int8_matmul_t(x_q, x_s, w_t, w_s, out_dtype=x.dtype)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def bf16_matmul(x, w):
    return torch.matmul(x, w)


def matmul(precision: str):
    """Matmul dispatch by approximation precision: 'bf16' | 'int8'."""
    if precision == "int8":
        return quantized_matmul
    return bf16_matmul


def flash(q, k, v, *, causal=True, window=0, cap=0.0, kv_keep_stride=1):
    """Blocked attention through the ``flash_attention`` kernel (its plain
    version for CPU tensors), differentiable through ``FlashAttention``.
    q: (B,H,Sq,hd); k/v: (B,KVH,Skv,hd); returns (B,H,Sq,hd)."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, window, cap,
                                kv_keep_stride)


def ssd(x, dt, a, b, c, *, chunk=128, d_skip=None, init_state=None,
        return_state=False):
    """Mamba2 SSD scan through the ``ssd_scan`` kernel (its plain version
    for CPU tensors), differentiable through ``SSDScan``. The D-skip is
    added outside the kernel in fp32, as the JAX package's TPU branch does.

    With ``init_state`` (B,H,P,N) fp32 or ``return_state`` (the serving
    path: chunked admission, the prefill handoff) the scan continues from
    that state (else zero) at any length (``ssd_scan_state`` pads to the
    kernel's chunks) and returns (y, final state); that form is forward
    only and raises where autograd would need its gradient."""
    if init_state is not None or return_state:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, a, b, c, d_skip, init_state)):
            raise NotImplementedError(
                "ops.ssd: the scan with a state in or out has no backward")
        y, state = ssd_scan_state(
            x.contiguous(), dt.float().contiguous(), a.float().contiguous(),
            b.contiguous(), c.contiguous(), chunk=chunk,
            init_state=init_state)
        return _d_skip(y, x, d_skip), state
    y = SSDScan.apply(x.contiguous(), dt.float().contiguous(),
                      a.float().contiguous(), b.contiguous(), c.contiguous(),
                      chunk)
    return _d_skip(y, x, d_skip)


def _d_skip(y, x, d_skip):
    if d_skip is not None:
        y = (y.float() + d_skip.float()[None, None, :, None]
             * x.float()).to(x.dtype)
    return y
