"""Plain PyTorch oracles of the W8A8 matmul: the counterparts of the JAX
package's ``kernels/ref.py`` (``quantize_rowwise``, ``int8_matmul_ref``,
``quantized_matmul_ref``). The paged kernel's plain version sits beside its
wrapper in ``kernels/paged_attention.py``."""
from __future__ import annotations

import torch


def quantize_rowwise(x: torch.Tensor, axis: int = -1):
    """Symmetric int8 quantization with per-row (``axis``-reduced) fp32
    scales. ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_ref(x_q, x_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """x_q: (M,K) int8, x_scale: (M,1) f32; w_q: (K,N) int8, w_scale: (1,N).

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
