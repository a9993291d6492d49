"""W8A8 int8 matmul with per-row / per-column scales: the CUDA kernel
``csrc/int8_matmul.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/int8_matmul.py``
(``int8_matmul`` / ``_kernel``). The int8 tensor-core instructions take
both operands K-major, so the kernel takes the weight as ``w_t`` (N, K)
with its scales ``w_scale`` (N, 1) (``int8_matmul_t``, what the model path
calls); ``int8_matmul`` keeps the JAX function's signature, ``w_q`` (K, N)
and ``w_scale`` (1, N), and transposes the weight on the way to the same
C entry point. The sums are exact int32, so every design equals
``int8_matmul_plain`` bit for bit.

Both wrappers also take a stack of E independent products, the MoE
layer's experts: x_q (E, M, K) and its scales (E, M, 1) by a weight of
(E, N, K) (``int8_matmul_t``) or (E, K, N) (``int8_matmul``) into an
(E, M, N) output, in ONE launch with the expert on the grid (the
counterpart of the JAX package's ``jax.vmap`` of the Pallas call in
``src/repro/models/moe.py`` ``_expert_ffn``). The design is chosen from
(M, N, K) as for one product.

``select_design`` picks one of three kernels from (M, N, K):

- ``"A"`` (M > 16, bound by operations: chunked admission, training):
  wgmma tiles of 128 x ``tile_n(M, N)`` fed by TMA;
- ``"B"`` (M <= 16, bound by bytes: the decode step): the weight streams
  once through ``mma.sync`` with the weight rows as the MMA's M;
- ``"fallback"`` (K % 16 != 0, which TMA and 16-byte loads cannot take):
  the ``__dp4a`` shared-memory tile.

Each wrapper runs the plain version for a CPU tensor and launches the kernel
for a CUDA tensor, raising on anything else; it never falls back to the
plain version. A ``meta`` tensor (the dry-run's trace) takes the card's
path up to the launch and returns the kernel's output uninitialised.
``launches`` counts every launch, ``design_launches`` the launches of each
design. ``work`` is one call's work; the wrapper enters it into an active
counting mode (``repro_torch.cost``) on the card and on ``meta`` alike.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import cost
from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_matmul_ref as int8_matmul_plain

launches = 0          # kernel launches since the last reset (plain runs: 0)
design_launches = {"A": 0, "B": 0, "fallback": 0}

STREAM_MAX_M = 16     # design B takes up to two 8-token MMA tiles
H100_SMS = 132

_DESIGN_CODES = {"fallback": 0, "A": 1, "B": 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def select_design(M: int, N: int, K: int) -> str:
    """The kernel for an (M, K) x (K, N) product: ``"fallback"`` when K is
    not a multiple of 16 (TMA's row stride and design B's 16-byte loads
    need it; K = 0 too), else ``"B"`` up to ``STREAM_MAX_M`` rows and
    ``"A"`` above."""
    if K % 16 or K == 0:
        return "fallback"
    return "B" if M <= STREAM_MAX_M else "A"


def work(M: int, K: int, N: int, out_bytes: int = 2, *, E: int = 1,
         scales: bool = True):
    """(operations, bytes) of E (M, K) x (K, N) products: 2·E·M·N·K
    integer operations; x and w read once (int8), the (M, N) outputs
    written once at ``out_bytes``, and with ``scales`` the fp32 row and
    column scales read once."""
    nbytes = E * (M * K + K * N + out_bytes * M * N)
    if scales:
        nbytes += E * (4 * M + 4 * N)
    return 2.0 * E * M * N * K, nbytes


def tile_n(M: int, N: int, sms: int = H100_SMS) -> int:
    """Design A's tile width: 256 (more reuse of each x tile) unless that
    leaves fewer than two waves of 128-row tiles on the card's SMs, then
    128 (twice the blocks)."""
    tiles = -(-M // 128) * -(-N // 256)
    return 256 if tiles >= 2 * sms else 128


def int8_matmul(x_q, x_scale, w_q, w_scale, *, out_dtype=torch.bfloat16):
    """x_q: ([E,] M,K) int8; x_scale: ([E,] M,1) f32; w_q: ([E,] K,N) int8;
    w_scale: ([E,] 1,N) f32 -> ([E,] M,N) ``out_dtype``."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(x_q, x_scale, w_q, w_scale, out_dtype)
    _check_device(x_q)
    return _launch(x_q, x_scale, w_q.transpose(-1, -2).contiguous(),
                   w_scale.transpose(-1, -2).contiguous(), out_dtype)


def int8_matmul_t(x_q, x_scale, w_t, w_scale, *, out_dtype=torch.bfloat16):
    """x_q: ([E,] M,K) int8; x_scale: ([E,] M,1) f32; w_t: ([E,] N,K) int8
    (the weight K-major); w_scale: ([E,] N,1) f32 -> ([E,] M,N)
    ``out_dtype``. A scale of None stands for unit scales (exactly the
    int32 sums, in ``out_dtype``)."""
    if x_q.device.type == "cpu":
        return int8_matmul_plain(
            x_q, 1.0 if x_scale is None else x_scale, w_t.transpose(-1, -2),
            1.0 if w_scale is None else w_scale.transpose(-1, -2),
            out_dtype)
    _check_device(x_q)
    return _launch(x_q, x_scale, w_t, w_scale, out_dtype)


def _check_device(x_q):
    if x_q.device.type not in ("cuda", "meta"):
        raise ValueError(
            f"int8_matmul: needs a CPU or CUDA tensor, got {x_q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(x_q, x_scale, w_t, w_scale, out_dtype):
    global launches
    if x_q.dim() not in (2, 3):
        raise ValueError(f"int8_matmul: x_q must be (M, K) or (E, M, K), "
                         f"got {tuple(x_q.shape)}")
    lead = tuple(x_q.shape[:-2])          # () or (E,)
    M, K = x_q.shape[-2:]
    N = w_t.shape[-2]
    dev = x_q.device
    for name, t, dt, shape in (("x_q", x_q, torch.int8, (M, K)),
                               ("x_scale", x_scale, torch.float32, (M, 1)),
                               ("w_t", w_t, torch.int8, (N, K)),
                               ("w_scale", w_scale, torch.float32, (N, 1))):
        shape = lead + shape
        if t is None and name.endswith("scale"):
            continue
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"int8_matmul: {name} must be a contiguous {dt} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"int8_matmul: unsupported out_dtype {out_dtype}")
    out = torch.empty(lead + (M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    design = select_design(M, N, K)
    if (x_q.data_ptr() | w_t.data_ptr()) % 16:
        design = "fallback"      # a view at an offset: no 16-byte loads
    if cost.active():
        cost.kernel("int8_matmul", design, *work(
            M, K, N, out.element_size(), E=lead[0] if lead else 1,
            scales=x_scale is not None))
    if dev.type == "meta":
        return out
    lib = _build.load("int8_matmul", _ARGTYPES)
    rc = lib.int8_matmul(x_q.data_ptr(), _ptr(x_scale), w_t.data_ptr(),
                         _ptr(w_scale), out.data_ptr(),
                         lead[0] if lead else 1, M, N, K,
                         _OUT_CODES[out_dtype], _DESIGN_CODES[design],
                         tile_n(M, N),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"int8_matmul: design {design} launch failed, "
                           f"cudaError {rc}")
    launches += 1
    design_launches[design] += 1
    return out
