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

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.ssd_scan import SSDScan


def int8_acc(x_q, w_q):
    """The exact int32 sums of ``x_q @ w_q`` as fp32 (``acc.astype(f32)`` in
    the JAX reference): ``int8_matmul`` with unit scales and an fp32 output,
    which multiplies by 1 exactly."""
    ones = torch.ones((), dtype=torch.float32, device=x_q.device)
    return int8_matmul(x_q, ones.expand(x_q.shape[0], 1).contiguous(), w_q,
                       ones.expand(1, w_q.shape[1]).contiguous(),
                       out_dtype=torch.float32)


class _Int8Matmul(torch.autograd.Function):
    """``int8_matmul`` for autograd. ``round`` and the int8 cast have zero
    derivative, so, as under ``jax.grad`` of ``int8_matmul_ref``, gradient
    reaches only the scales: with ``out = (acc * x_s) * w_s``,
    ``d x_s = sum_n (g * w_s) * acc`` and ``d w_s = sum_m g * (acc * x_s)``."""

    @staticmethod
    def forward(ctx, x_q, x_scale, w_q, w_scale, out_dtype):
        ctx.save_for_backward(x_q, x_scale, w_q, w_scale)
        return int8_matmul(x_q, x_scale, w_q, w_scale, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x_q, x_scale, w_q, w_scale = ctx.saved_tensors
        acc = int8_acc(x_q, w_q)
        g = g.float()
        d_xs = ((g * w_scale) * acc).sum(1, keepdim=True)
        d_ws = (g * (acc * x_scale)).sum(0, keepdim=True)
        return None, d_xs, None, d_ws, None


def quantized_matmul(x, w):
    """W8A8 dynamic-quantized matmul (the Pliant lower-precision knob):
    x per row and w per column are quantized on every call, as in the JAX
    package, then multiplied by ``int8_matmul``. Differentiable: autograd
    carries the scales' gradient through ``quantize_rowwise``'s row max."""
    lead = x.shape[:-1]
    x_q, x_s = ref.quantize_rowwise(x.reshape(-1, x.shape[-1]))
    w_q, w_s = ref.quantize_rowwise(w, axis=0)
    y = _Int8Matmul.apply(x_q, x_s, w_q, w_s, x.dtype)
    return y.reshape(lead + (w.shape[-1],))


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


def ssd(x, dt, a, b, c, *, chunk=128, d_skip=None):
    """Mamba2 SSD scan through the ``ssd_scan`` kernel (its plain version
    for CPU tensors), differentiable through ``SSDScan``. The D-skip is
    added outside the kernel in fp32, as the JAX package's TPU branch does."""
    y = SSDScan.apply(x.contiguous(), dt.float().contiguous(),
                      a.float().contiguous(), b.contiguous(), c.contiguous(),
                      chunk)
    if d_skip is not None:
        y = (y.float() + d_skip.float()[None, None, :, None]
             * x.float()).to(x.dtype)
    return y
