"""Symmetric int8 quantisation of rows and its backward: the CUDA kernels
of ``csrc/quantize_rows.cu`` and their plain PyTorch versions,
``ref.quantize_rowwise`` and ``quantize_rows_backward_plain``.

The int8 rungs quantise the activations of every product (and, in
training, the weights, then carry the scales' gradient back to both). The
JAX package writes this in jnp ops (``src/repro/kernels/ref.py``
``quantize_rowwise``), which XLA fuses and differentiates; it has no Pallas
kernel. Eager PyTorch would run ten launches forward and a dozen backward,
so the port runs one kernel each way, bound by bytes, equal to the plain
version bit for bit for finite inputs.

Each wrapper runs the plain version for a CPU tensor and launches its
kernel for a CUDA tensor, raising on anything else; it never falls back.
A ``meta`` tensor (the dry-run's trace) takes the card's path up to the
launch. ``launches`` counts the launches of both kernels; ``work`` is one
call's work, which the wrappers enter into an active counting mode
(``repro_torch.cost``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import cost
from repro_torch.kernels import _build
from repro_torch.kernels.ref import quantize_rowwise as quantize_rows_plain

launches = 0          # kernel launches since the last reset (plain runs: 0)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGTYPES_BWD = _ARGTYPES          # x, d_s, d x, M, K, dtype, stream


def work(M: int, K: int, esize: int, backward: bool = False):
    """(operations, bytes) of one call on (M, K) rows of ``esize``-byte
    entries. Bytes: x read once, q (int8) and s written once; backward x
    and d s read, d x written in x's dtype. Operations: four an entry
    (|x|, the row max, the division, the rounding; backward the mask, the
    sign and two products), a few a byte: the kernels are bound by
    bytes."""
    nbytes = M * K * esize + (M * K * esize if backward else M * K) + 4 * M
    return 4.0 * M * K, nbytes


def quantize_rows_backward_plain(x, d_s):
    """The gradient reaching the rows of ``x`` (M, K) from ``d_s`` (M, 1)
    fp32, the gradient of their scales ``max(amax_k |x|, 1e-8) / 127``: the
    rules autograd applies through ``quantize_rowwise`` (division,
    ``clamp_min``, ``amax``, ``abs``, the cast), op for op, so the values
    are autograd's bit for bit. ``round`` and the int8 cast have zero
    derivative: nothing flows through the quantised values."""
    xf = x.float()
    a = xf.abs()
    amax = a.amax(dim=-1, keepdim=True)
    g = d_s / amax.new_full((), 127.0)
    g = torch.where(amax >= 1e-8, g, 0.0)
    mask = a == amax
    g = (g / mask.sum(dim=-1, keepdim=True)) * mask
    return (g * xf.sgn()).to(x.dtype)


def _check(name, x):
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: needs a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES or not x.is_contiguous() \
            or x.shape[1] == 0:
        raise ValueError(
            f"{name}: x must be a contiguous (M, K > 0) fp32, bf16 or fp16 "
            f"tensor, got {x.dtype} {tuple(x.shape)} "
            f"(contiguous={x.is_contiguous()})")


def quantize_rows_backward(x, d_s):
    """x: (M, K) fp32 / bf16 / fp16, d_s: (M, 1) fp32 -> d x (M, K) in x's
    dtype (see ``quantize_rows_backward_plain``)."""
    global launches
    if x.device.type == "cpu":
        return quantize_rows_backward_plain(x, d_s)
    _check("quantize_rows_backward", x)
    M, K = x.shape
    d_s = d_s.contiguous()
    if d_s.dtype != torch.float32 or d_s.device != x.device \
            or d_s.numel() != M:
        raise ValueError(f"quantize_rows_backward: d_s must be ({M}, 1) "
                         f"fp32 on {x.device}, got {d_s.dtype} "
                         f"{tuple(d_s.shape)} on {d_s.device}")
    dx = torch.empty_like(x)
    if M == 0:
        return dx
    if cost.active():
        cost.kernel("quantize_rows_backward", "-",
                    *work(M, K, x.element_size(), backward=True))
    if x.device.type == "meta":
        return dx
    lib = _build.load("quantize_rows", _ARGTYPES_BWD,
                      "quantize_rows_backward")
    rc = lib.quantize_rows_backward(
        x.data_ptr(), d_s.data_ptr(), dx.data_ptr(), M, K,
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(
            f"quantize_rows_backward: launch failed, cudaError {rc}")
    launches += 1
    return dx


def quantize_rows(x):
    """x: (M, K) fp32 / bf16 / fp16 -> (q (M, K) int8, s (M, 1) fp32), the
    scale of each row over its K entries."""
    global launches
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    _check("quantize_rows", x)
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, s
    if cost.active():
        cost.kernel("quantize_rows", "-", *work(M, K, x.element_size()))
    if x.device.type == "meta":
        return q, s
    lib = _build.load("quantize_rows", _ARGTYPES)
    rc = lib.quantize_rows(x.data_ptr(), q.data_ptr(), s.data_ptr(), M, K,
                           _DTYPE_CODES[x.dtype],
                           torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"quantize_rows: launch failed, cudaError {rc}")
    launches += 1
    return q, s
