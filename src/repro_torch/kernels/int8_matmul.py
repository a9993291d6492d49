"""W8A8 int8 matmul with per-row / per-column scales: the CUDA kernel
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/int8_matmul.py``
(``int8_matmul`` / ``_kernel``). On the H100 it is bound by bytes at decode
(the int8 weight streams once for a handful of rows) and by int8 operations
at prefill; the kernel stages four K-consecutive bytes of each operand per
int32 word in shared memory and accumulates with ``__dp4a`` in int32 across
all of K, so its result equals ``int8_matmul_plain`` bit for bit. Ragged M,
N and K are masked in the kernel.

``int8_matmul`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, raising on anything else; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_matmul_ref as int8_matmul_plain

launches = 0          # kernel launches since the last reset (plain runs: 0)

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def int8_matmul(x_q, x_scale, w_q, w_scale, *, out_dtype=torch.bfloat16):
    """x_q: (M,K) int8; x_scale: (M,1) f32; w_q: (K,N) int8; w_scale: (1,N)
    f32 -> (M,N) ``out_dtype``."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale, out_dtype)
    return _launch(x_q, x_scale, w_q, w_scale, out_dtype)


def _launch(x_q, x_scale, w_q, w_scale, out_dtype):
    global launches
    M, K = x_q.shape
    K2, N = w_q.shape
    dev = x_q.device
    if dev.type != "cuda":
        raise ValueError(f"int8_matmul: needs a CPU or CUDA tensor, got {dev}")
    for name, t, dt, shape in (("x_q", x_q, torch.int8, (M, K)),
                               ("x_scale", x_scale, torch.float32, (M, 1)),
                               ("w_q", w_q, torch.int8, (K, N)),
                               ("w_scale", w_scale, torch.float32, (1, N))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"int8_matmul: {name} must be a contiguous {dt} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"int8_matmul: unsupported out_dtype {out_dtype}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("int8_matmul", _ARGTYPES)
    rc = lib.int8_matmul(x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(),
                         w_scale.data_ptr(), out.data_ptr(), M, N, K,
                         _OUT_CODES[out_dtype],
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"int8_matmul: launch failed, cudaError {rc}")
    launches += 1
    return out
