"""Public entry points of the kernels, dispatched on the tensor's device.

Counterpart of the JAX package's ``kernels/ops.py``: a CUDA tensor launches
the hand-written kernel (or raises), a CPU tensor takes the kernel's plain
version. There is no switch beyond the device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401


def quantized_matmul(x, w):
    """W8A8 dynamic-quantized matmul (the Pliant lower-precision knob):
    x per row and w per column are quantized on every call, as in the JAX
    package, then multiplied by ``int8_matmul``."""
    lead = x.shape[:-1]
    x_q, x_s = ref.quantize_rowwise(x.reshape(-1, x.shape[-1]))
    w_q, w_s = ref.quantize_rowwise(w, axis=0)
    y = int8_matmul(x_q, x_s, w_q, w_s, out_dtype=x.dtype)
    return y.reshape(lead + (w.shape[-1],))


def bf16_matmul(x, w):
    return torch.matmul(x, w)


def matmul(precision: str):
    """Matmul dispatch by approximation precision: 'bf16' | 'int8'."""
    if precision == "int8":
        return quantized_matmul
    return bf16_matmul
