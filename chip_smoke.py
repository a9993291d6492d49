#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py            # needs one CUDA card

Phases, each reported on its own line:

1. build     nvcc builds every kernel of the port from ``csrc/``, one
             process per source, all at once.
2. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes its path gives it (phi4-mini-3.8b serving widths;
             mamba2-780m training widths for ``ssd_scan`` and the int8
             projections; phi4-mini-3.8b training at 2 x 4096 tokens for
             ``flash_attention``, plus window + softcap + GQA, stride-2
             perforation and ragged Sq != Skv cases), fp32 and bf16, with
             its time beside the plain version's, a library call's where one
             computes the same function, and its bound. Then the training
             path's gradients: ``SSDScan`` (kernel forward, VJP of the
             chunked twin) against autograd through ``ssd_chunked_ref`` on
             the CPU, the backward's time at the training shape,
             ``FlashAttention`` against the plain version's VJP on the CPU,
             one layer's attention core at phi4-mini's training cell timed
             through the kernel and through ``_causal_chunked`` at stride
             1 and 2, and the differentiable ``quantized_matmul``'s gradients (zero
             pattern included) against the CPU plain path.
3. parity    phi4-mini-3.8b-smoke served in fp32 twice from the same seeded
             weights, on the card and on the CPU: the greedy token streams
             of each serving rung must be equal. mamba2-780m-smoke (4 x 32
             tokens, no remat) and phi4-mini-3.8b-smoke (2 x 4096 tokens,
             remat "full") trained in fp32 three steps on each training
             rung, on the card and on the CPU from the same weights: the
             losses must agree.
4. serve     the serving slice at full width: ``repro_torch.launch.serve``
             on phi4-mini-3.8b (32 layers, bf16, random weights) under a QoS
             target tight enough that the Pliant runtime swaps variants,
             launch counters zeroed just before and read just after; then a
             ``request_variant`` walk timing decode steps per rung.
5. profile   ``torch.profiler`` over decode steps of a full batch per rung.
6. train     the training slice at full width: ``repro_torch.launch.train``
             on mamba2-780m (48 layers, fp32 params, batch 4 x 1024 tokens,
             random weights) under ``--pliant``, launch counters zeroed just
             before and read just after; then each training rung pinned by
             ``table.executable(i)`` (median step time, peak memory) and one
             profiled step per rung (device-busy share, largest kernels).
7. train-attn  the dense-attention training slice at full width:
             ``repro_torch.launch.train.main(..., remat="full")`` on
             phi4-mini-3.8b (32 layers, fp32 params and AdamW, batch 2 x
             4096 tokens, random weights) under ``--pliant``, launch
             counters zeroed just before and read just after; then each
             rung pinned (median step time, peak memory, launches a step),
             the int8 rung again with its causal attention through
             ``_causal_chunked`` at stride 1 (the stride rung less its
             perforation), and one profiled step per rung.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``. Any
failure raises: the script then exits non-zero without the result line, as
it does when CUDA is unavailable or the repository's sources are missing.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks (dense, 700 W): device memory bytes/s and
# the operation rates for the kernels' input types.
HBM_BW = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# bf16 rounds to 8 significant bits: kernel and plain version sum in other
# orders, so their bf16 outputs may differ by one bf16 step (2^-7 relative;
# the attention outputs here stay below 4 in magnitude).
BF16_ATOL = 2 ** -7 * 4
FP32_ATOL = 2e-5        # fp32 attention: reassociated sums of ~1e3 terms
# bf16 flash attention, per element: one bf16 step (2^-7 |ref|) plus
# BF16_ROW times the rms of the element's output row (see check_flash).
BF16_ROW = 2 ** -6


def timed(fn, device, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` calls (CUDA events on
    the card, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------- int8_matmul --

def int8_case(M, K, N, device, seed=0):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x_q = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    xs = torch.rand((M, 1), generator=g) * 1e-2 + 1e-4
    ws = torch.rand((1, N), generator=g) * 1e-2 + 1e-4
    return [t.to(device) for t in (x_q, xs, w_q, ws)]


def int8_bound_ms(M, K, N, out_bytes=2):
    nbytes = M * K + K * N + 4 * M + 4 * N + out_bytes * M * N
    ops = 2.0 * M * N * K
    t_bytes, t_ops = nbytes / HBM_BW, ops / INT8_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_int8(device, shapes, iters=20):
    """The int8 kernel against its plain version: the int32 sums are exact
    in both, and the epilogue rounds identically, so they must agree bit
    for bit (tolerance 0)."""
    import torch
    from repro_torch.kernels import int8_matmul as mod
    rows = []
    for M, K, N in shapes:
        x_q, xs, w_q, ws = int8_case(M, K, N, device)
        for dt in (torch.bfloat16, torch.float32):
            out = mod.int8_matmul(x_q, xs, w_q, ws, out_dtype=dt)
            ref = mod.int8_matmul_plain(x_q, xs, w_q, ws, dt)
            err = max_err(out, ref)
            assert err == 0.0, (M, K, N, dt, err)
        kern = timed(lambda: mod.int8_matmul(x_q, xs, w_q, ws), device, iters)
        plain = timed(lambda: mod.int8_matmul_plain(
            x_q, xs, w_q, ws, torch.bfloat16), device, iters)
        lib = None
        if device.type == "cuda" and M > 16 and K % 8 == 0 and N % 8 == 0:
            lib = timed(lambda: (torch._int_mm(x_q, w_q).float() * xs
                                 * ws).to(torch.bfloat16), device, iters)
        bound, by = int8_bound_ms(M, K, N)
        rows.append(dict(M=M, K=K, N=N, max_abs_err=err, ms=kern,
                         plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by))
        print(f"int8_matmul M={M} K={K} N={N}: max_abs_err={err} "
              f"ms={kern:.4f} plain_ms={plain:.4f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={bound:.4f} ({by})")
    return rows


# -------------------------------------------------------------- ssd_scan --

def ssd_case(B, S, H, P, N, dtype, device, seed=0):
    """Inputs at the model's scales: x and b, c unit-ish, dt a softplus of
    a shifted normal (as ``softplus(x @ in_dt + dt_bias)``), a = -exp(A_log)
    with A_log = log(uniform[1, 16])."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(B, S, H, P)), dtype=torch.float32)
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.normal(size=(B, S, H)) - 3.0, dtype=torch.float32))
    a = -torch.tensor(rng.uniform(1.0, 16.0, size=(H,)), dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(B, S, N)) * N ** -0.5,
                     dtype=torch.float32)
    c = torch.tensor(rng.normal(size=(B, S, N)) * N ** -0.5,
                     dtype=torch.float32)
    x, b, c = (t.to(device=device, dtype=dtype) for t in (x, b, c))
    return [x, dt.to(device), a.to(device), b, c]


def ssd_bound_ms(B, S, H, P, N, Q, esize):
    """Bytes: x read and y written in x's dtype, dt in fp32, b and c once.
    Operations: the lower triangle of C·Bᵀ (N·Q(Q+1) FLOP) once per (batch,
    chunk), as B and C are one group shared by every head; per (batch,
    head, chunk) the lower triangle of W·(dt·x) (P·Q(Q+1)), C·Sᵀ and the
    state update (2·Q·N·P each); fp32 on the CUDA cores."""
    nbytes = 2 * B * S * H * P * esize + 4 * B * S * H + 4 * H \
        + 2 * B * S * N * esize
    nc = S // Q
    ops = float(N * Q * (Q + 1)) * B * nc \
        + float(P * Q * (Q + 1) + 4 * Q * N * P) * B * H * nc
    t_bytes, t_ops = nbytes / HBM_BW, ops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_ssd(device, shapes, iters=10, dtypes=None):
    """``ssd_scan`` against ``ssd_scan_plain`` on the card, fp32 and bf16.
    Both compute in fp32 from the same (exactly upcast) inputs and differ
    only in the order of their sums: fp32 outputs within 1e-5 of the
    largest |y| (~1e-6 measured on the CPU against the Pallas kernel), bf16
    outputs within one bf16 step (2^-8 relative) of the largest |y|."""
    import torch
    from repro_torch.kernels import ssd_scan as mod
    rows = []
    for B, S, H, P, N, Q in shapes:
        for dtype in dtypes or (torch.float32, torch.bfloat16):
            x, dt, a, b, c = ssd_case(B, S, H, P, N, dtype, device)
            out = mod.ssd_scan(x, dt, a, b, c, chunk=Q)
            ref = mod.ssd_scan_plain(x, dt, a, b, c, chunk=Q)
            torch.cuda.synchronize()
            scale = float(ref.float().abs().max())
            tol = (1e-5 if dtype == torch.float32 else 2 ** -8) * scale
            err = max_err(out, ref)
            assert torch.isfinite(out).all() and err <= tol, \
                (B, S, H, P, N, Q, dtype, err, tol)
            kern = timed(lambda: mod.ssd_scan(x, dt, a, b, c, chunk=Q),
                         device, iters)
            plain = timed(lambda: mod.ssd_scan_plain(x, dt, a, b, c,
                                                     chunk=Q), device, iters)
            bound, by = ssd_bound_ms(B, S, H, P, N, Q, x.element_size())
            name = "fp32" if dtype == torch.float32 else "bf16"
            rows.append(dict(shape=(B, S, H, P, N, Q), dtype=name,
                             max_abs_err=err, tol=tol, ms=kern,
                             plain_ms=plain, library_ms=None,
                             bound_ms=bound, bound_by=by))
            print(f"ssd_scan {name} B={B} S={S} H={H} P={P} N={N} Q={Q}: "
                  f"max_abs_err={err:.3g} (tol {tol:.3g}) ms={kern:.4f} "
                  f"plain_ms={plain:.4f} library_ms=null "
                  f"bound_ms={bound:.5f} ({by})")
    return rows


def check_ssd_grads(device, shape=(2, 256, 4, 64, 128, 128)):
    """``SSDScan`` on the card (kernel forward, ``ssd_scan_backward``)
    against autograd through the ``ssd_chunked_ref`` twin on the CPU, fp32.
    The decays are exps of differences of fp32 cumulative sums that reach
    ~10^2 over a chunk of 128 here, and the two devices sum them in other
    orders: y agrees to ~1e-5 of its largest entry (measured 1e-5), so y is
    held to 1e-4 and each gradient, which sums such terms over every token
    and chunk pair, to 1e-3 of its largest entry."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as mod
    B, S, H, P, N, Q = shape
    ins = ssd_case(B, S, H, P, N, torch.float32, torch.device("cpu"), seed=1)
    gy = torch.tensor(np.random.default_rng(2).normal(size=(B, S, H, P)),
                      dtype=torch.float32)
    cpu = [t.clone().requires_grad_(True) for t in ins]
    want = ref.ssd_chunked_ref(*cpu, chunk=Q)
    want_g = torch.autograd.grad(want, cpu, gy)
    dev = [t.to(device).requires_grad_(True) for t in ins]
    got = mod.SSDScan.apply(*dev, Q)
    got_g = torch.autograd.grad(got, dev, gy.to(device))
    rel = {"y": max_err(got.detach().cpu(), want.detach())
           / float(want.detach().abs().max())}
    for name, g, w in zip(("x", "dt", "a", "b", "c"), got_g, want_g):
        rel[name] = max_err(g.cpu(), w) / float(w.abs().max())
        assert torch.isfinite(g).all(), name
    print(f"ssd_scan grads B={B} S={S} H={H} P={P} N={N} Q={Q}: card vs "
          f"cpu ssd_chunked_ref, max_abs_err / max|ref| "
          + " ".join(f"{k}={v:.3g}" for k, v in rel.items()))
    assert rel.pop("y") <= 1e-4 and max(rel.values()) <= 1e-3, rel


def time_ssd_backward(device, shape=(4, 1024, 48, 64, 128, 128), iters=5):
    """Milliseconds of one ``ssd_scan_backward`` (the VJP through the
    chunked twin) at the training shape, fp32, and its peak extra memory."""
    import torch
    from repro_torch.kernels import ssd_scan as mod
    B, S, H, P, N, Q = shape
    x, dt, a, b, c = ssd_case(B, S, H, P, N, torch.float32, device, seed=3)
    gy = torch.randn_like(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = timed(lambda: mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q),
               device, iters, warmup=1)
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"ssd_scan_backward B={B} S={S} H={H} P={P} N={N} Q={Q}: "
          f"ms={ms:.3f} (x48 layers = {48 * ms:.1f} ms a step) "
          f"peak extra {extra:.2f} GiB")
    return ms


def check_int8_grads(device, M=256, K=1536, N=3072):
    """The differentiable ``quantized_matmul`` on the card against the CPU
    plain path: the forward bit for bit (exact int32 sums, identical
    quantisation), the gradients of x and w with the same zero pattern
    (only each row's / column's arg-max entry is reached) and within 1e-4
    of their largest entry (sums over N = 3072 or M terms in other
    orders)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(M, K)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(K, N)) * K ** -0.5, dtype=torch.float32)
    g0 = torch.tensor(rng.normal(size=(M, N)), dtype=torch.float32)
    out = []
    for d in (torch.device("cpu"), device):
        xs, ws = x.to(d).requires_grad_(True), w.to(d).requires_grad_(True)
        y = ops.quantized_matmul(xs, ws)
        gx, gw = torch.autograd.grad((y * g0.to(d)).sum(), (xs, ws))
        out.append([t.detach().cpu() for t in (y, gx, gw)])
    (yc, gxc, gwc), (yd, gxd, gwd) = out
    assert torch.equal(yc, yd), max_err(yc, yd)
    for name, a, b in (("x", gxd, gxc), ("w", gwd, gwc)):
        assert torch.equal(a != 0, b != 0), name
        err = max_err(a, b)
        assert err <= 1e-4 * float(b.abs().max()), (name, err)
    print(f"quantized_matmul grads M={M} K={K} N={N}: y bit-equal, "
          f"nonzero x-grads {int((gxd != 0).sum())}/{M * K} "
          f"w-grads {int((gwd != 0).sum())}/{K * N} (patterns equal), "
          f"max_abs_err x={max_err(gxd, gxc):.3g} w={max_err(gwd, gwc):.3g}")


# ------------------------------------------------------- flash_attention --

def flash_case(B, H, KVH, Sq, Skv, hd, dtype, device, seed=0):
    """q, k, v at unit scale (the model's RoPE'd projections are O(1)):
    scores q.k / sqrt(hd) of unit spread."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, H, Sq, hd), (B, KVH, Skv, hd), (B, KVH, Skv, hd)):
        out.append(torch.tensor(rng.normal(size=shape), dtype=torch.float32
                                ).to(device=device, dtype=dtype))
    return out


def flash_kept(Sq, Skv, kw, device, rows=None):
    """(rows, Skv) bool: the (query, key) pairs whose score the function
    needs, entries of the running blocks that survive the mask, on the
    default (128, 128) block grid."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    qpos = torch.arange(Sq, device=device) if rows is None else rows
    kpos = torch.arange(Skv, device=device)
    bq, bk = min(128, Sq), min(128, Skv)
    return fa.block_runs(qpos, kpos, causal=kw["causal"], window=kw["window"],
                         kv_keep_stride=kw["kv_keep_stride"], bq=bq,
                         bk=bk) \
        & fa.entry_mask(qpos, kpos, causal=kw["causal"], window=kw["window"],
                        n_kv=Skv)


def flash_kept_pairs(Sq, Skv, kw, device):
    """How many pairs ``flash_kept`` holds, counted 1024 query rows at a
    time."""
    import torch
    return sum(int(flash_kept(Sq, Skv, kw, device, torch.arange(
        r0, min(r0 + 1024, Sq), device=device)).sum())
        for r0 in range(0, Sq, 1024))


def flash_bound_ms(B, H, KVH, Sq, Skv, hd, esize, pairs):
    """Bytes: q, k, v read once and o written once. Operations: Q.K^T and
    P.V over the pairs the function needs, 4 hd FLOP a pair per head (the
    lower triangle S(S+1)/2 for plain causal attention), at the input
    type's peak."""
    nbytes = esize * (2 * B * H * Sq * hd + 2 * B * KVH * Skv * hd)
    ops = 4.0 * B * H * hd * pairs
    peak = FP32_FLOPS if esize == 4 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BW, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_kernel_names(fn):
    """Names of the CUDA kernels one call of ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def bf16_row_excess(out, ref):
    """The largest amount by which an element of ``out`` strays from
    ``ref`` beyond one bf16 step (2^-7 |ref|), in units of the rms of its
    row of ``ref`` (over hd)."""
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((o - r).abs() - 2 ** -7 * r.abs()).clamp_min(0)
                 .div_(rms).max())


def check_flash(device, cases, iters=10):
    """``flash_attention`` against ``flash_attention_plain`` on the card.
    Both compute the scores, the softmax and P.V in fp32 from the same
    (exactly upcast) inputs and differ in the order of their sums (the
    kernel's online softmax over key tiles against one pass over all
    keys): fp32 outputs (|o| <= ~4) within FP32_ATOL. In bf16, p is also
    rounded to bf16, against a running max in the kernel and the final max
    in the plain version, each rounding off by up to 2^-8 of p and
    typically under 2^-9: as o_d sums p_j v_jd of random sign, that moves
    an output element by a small multiple of 2^-9 of its row's rms, and the
    output's own rounding by up to one bf16 step. So each bf16 element is
    held to ``|out - ref| <= 2^-7 |ref| + BF16_ROW * rms(ref's row)``,
    BF16_ROW = 2^-6 = 8 * 2^-9 (the excess measured is printed). The
    output is small: at unit-scale q, k, v a causal row r averages ~r/e keys, so
    |o| ~ sqrt(e / r), ~0.03 at the median row of S 4096 (the median |ref|
    is printed), and an absolute tolerance would pass a few-percent fault;
    this one does not (a 2% scaling of every element fails it).
    ``library_ms``: ``F.scaled_dot_product_attention`` on the same inputs
    where one call computes the same function (is_causal for causal
    attention, a boolean mask of the kept entries for window and stride;
    no softcap), with the kernels it ran."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for c in cases:
        B, H, KVH, Sq, Skv, hd = c["shape"]
        kw = dict(causal=c.get("causal", True), window=c.get("window", 0),
                  cap=c.get("cap", 0.0),
                  kv_keep_stride=c.get("stride", 1))
        q, k, v = flash_case(B, H, KVH, Sq, Skv, hd, c["dtype"], device)
        out = fa.flash_attention(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        assert torch.isfinite(out).all(), c["name"]
        if c["dtype"] == torch.float32:
            tol, excess = FP32_ATOL, None
            assert err <= tol, (c["name"], err, tol)
            tol_s = f"{tol:.3g}"
        else:
            tol, excess = BF16_ROW, bf16_row_excess(out, ref)
            assert excess <= tol, (c["name"], excess, tol)
            tol_s = (f"2^-7 |ref| + {tol:.3g} row rms: excess {excess:.3g} "
                     f"row rms, median |ref| "
                     f"{float(ref.float().abs().median()):.3g}")
        kern = timed(lambda: fa.flash_attention(q, k, v, **kw), device, iters)
        plain = timed(lambda: fa.flash_attention_plain(q, k, v, **kw),
                      device, 3, warmup=1)
        lib, backend = None, "none: no single call computes a softcap"
        if not kw["cap"]:
            if kw["causal"] and not kw["window"] and kw["kv_keep_stride"] \
                    == 1 and Sq == Skv:
                sdpa_kw = dict(is_causal=True)
            else:
                sdpa_kw = dict(attn_mask=flash_kept(Sq, Skv, kw, device))

            def lib_call():
                return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                      **sdpa_kw)
            lib_err = max_err(lib_call(), ref)
            lib = timed(lib_call, device, iters)
            backend = ",".join(cuda_kernel_names(lib_call))[:160] \
                + f" (max_abs_err vs plain {lib_err:.3g})"
        pairs = flash_kept_pairs(Sq, Skv, kw, device)
        bound, by = flash_bound_ms(B, H, KVH, Sq, Skv, hd, q.element_size(),
                                   pairs)
        rows.append(dict(name=c["name"], shape=c["shape"],
                         dtype=str(c["dtype"]).split(".")[-1],
                         max_abs_err=err, tol=tol, row_excess=excess,
                         ms=kern, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by))
        print(f"flash_attention {c['name']} B={B} H={H} KVH={KVH} Sq={Sq} "
              f"Skv={Skv} hd={hd} {rows[-1]['dtype']}: max_abs_err={err:.3g} "
              f"(tol {tol_s}) ms={kern:.4f} plain_ms={plain:.4f} "
              f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={bound:.4f} ({by}, {pairs} pairs) "
              f"library: {backend}")
    return rows


def phi4_flash_cases():
    import torch
    cell = (2, 24, 8, 4096, 4096, 128)      # phi4-mini training, 2 x 4096
    return [
        dict(name="cell-fp32", shape=cell, dtype=torch.float32),
        dict(name="cell-bf16", shape=cell, dtype=torch.bfloat16),
        dict(name="cell-b1-fp32", shape=(1,) + cell[1:],
             dtype=torch.float32),            # int8+drop50% keeps 1 row
        dict(name="window+softcap+gqa", shape=(2, 24, 4, 2048, 2048, 128),
             dtype=torch.float32, window=512, cap=50.0),
        dict(name="stride2", shape=(2, 24, 8, 2048, 2048, 128),
             dtype=torch.float32, stride=2),
        dict(name="ragged", shape=(2, 8, 2, 1000, 1500, 80),
             dtype=torch.float32, causal=True, window=300),
        dict(name="ragged-bf16-hd256", shape=(1, 4, 1, 777, 333, 256),
             dtype=torch.bfloat16, causal=False),
    ]


def check_flash_grads(device, shape=(2, 8, 2, 1100, 1100, 64)):
    """``FlashAttention`` on the card (kernel forward, the plain version's
    VJP recomputed per block of 1024 query rows) against autograd through
    ``flash_attention_plain`` on the CPU, fp32, causal with perforation
    (stride 2) over two row blocks. The card's forward is held to
    FP32_ATOL, each gradient to 1e-5 of its largest entry (sums over up to
    1100 terms in other orders)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, H, KVH, S, _, hd = shape
    ins = flash_case(B, H, KVH, S, S, hd, torch.float32,
                     torch.device("cpu"), seed=5)
    go = torch.tensor(np.random.default_rng(6).normal(size=(B, H, S, hd)),
                      dtype=torch.float32)
    kw = (True, 0, 0.0, 2)
    cpu = [t.clone().requires_grad_(True) for t in ins]
    want = fa.flash_attention_plain(*cpu, causal=True, kv_keep_stride=2)
    want_g = torch.autograd.grad(want, cpu, go)
    dev = [t.to(device).requires_grad_(True) for t in ins]
    got = fa.FlashAttention.apply(*dev, *kw)
    got_g = torch.autograd.grad(got, dev, go.to(device))
    err = max_err(got.detach().cpu(), want.detach())
    rel = {n: max_err(g.cpu(), w) / float(w.abs().max())
           for n, g, w in zip("qkv", got_g, want_g)}
    print(f"flash_attention grads B={B} H={H} KVH={KVH} S={S} hd={hd} "
          f"stride 2: card vs cpu plain, out max_abs_err={err:.3g}, "
          f"grads max_abs_err / max|ref| "
          + " ".join(f"{k}={v:.3g}" for k, v in rel.items()))
    assert err <= FP32_ATOL and max(rel.values()) <= 1e-5, (err, rel)


# ------------------------------------------------------- paged_attention --

def paged_case(lengths, *, G, R, hd, P, M, dtype, quantized, device,
               seed=0, speculative=2):
    """A paged pool holding ``lengths[b]`` resident tokens per slot (ragged
    page counts, partial last pages), the decode query at position
    ``lengths[b]``, plus ``speculative`` mapped-but-future pages per slot
    filled with large values that must not matter."""
    import numpy as np
    import torch
    from repro_torch.models.attention import quantize_kv
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_pages = 1 + B * M
    kp = torch.tensor(rng.normal(size=(n_pages, P, G, hd)) * 0.3,
                      dtype=torch.float32)
    vp = torch.tensor(rng.normal(size=(n_pages, P, G, hd)),
                      dtype=torch.float32)
    block = np.zeros((B, M), np.int32)
    ppos = np.full((n_pages, P), -1, np.int32)
    pid = 1
    for b, L in enumerate(lengths):
        live = -(-(L + 1) // P)
        for lp in range(min(live + speculative, M)):
            block[b, lp] = pid
            if lp < live:
                top = min(L + 1, (lp + 1) * P)
                ppos[pid, : max(top - lp * P, 0)] = np.arange(lp * P, top)
            else:                                  # future page: scrambled
                kp[pid] = 1e3
                vp[pid] = -1e3
            pid += 1
    if quantized:
        kp, vp = quantize_kv(kp.clamp(-6, 6)), quantize_kv(vp.clamp(-6, 6))
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.tensor(rng.normal(size=(B, G, R, hd)), dtype=dtype)
    pos = torch.tensor(np.asarray(lengths, np.int32))
    return [t.to(device) for t in (q, kp, vp, torch.tensor(ppos),
                                   torch.tensor(block), pos)]


def paged_live_pages(block, position, P, window):
    import torch
    M = block.shape[1]
    m = torch.arange(M, device=block.device)
    run = (block != 0) & (m * P <= position.long()[:, None])
    if window:
        run &= (m + 1) * P - 1 > position.long()[:, None] - window
    return int(run.sum()), int(sum(
        min(int(p) + 1, window or int(p) + 1) for p in position.tolist()))


def check_paged(device, cases, iters=20):
    import torch
    from repro_torch.kernels import paged_attention as mod
    from repro_torch.models.attention import KV_SCALE
    rows = []
    for c in cases:
        G, R, hd, P = c["G"], c["R"], c["hd"], c["P"]
        lengths, M = c["lengths"], c["M"]
        q, kp, vp, ppos, block, pos = paged_case(
            lengths, G=G, R=R, hd=hd, P=P, M=M, dtype=c["dtype"],
            quantized=c["int8"], device=device)
        kw = dict(window=c.get("window", 0), cap=c.get("cap", 0.0),
                  kv_scale=KV_SCALE if c["int8"] else 0.0)
        out = mod.paged_attention(q, kp, vp, ppos, block, pos, **kw)
        ref = mod.paged_attention_plain(q, kp, vp, ppos, block, pos, **kw)
        tol = FP32_ATOL if c["dtype"] == torch.float32 else BF16_ATOL
        err = max_err(out, ref)
        assert err <= tol, (c["name"], err, tol)
        kern = timed(lambda: mod.paged_attention(q, kp, vp, ppos, block, pos,
                                                 **kw), device, iters)
        plain = timed(lambda: mod.paged_attention_plain(
            q, kp, vp, ppos, block, pos, **kw), device, iters)
        live, tokens = paged_live_pages(block, pos, P, kw["window"])
        kv_bytes = kp.element_size()
        nbytes = mod.decode_hbm_bytes(live, P, G, hd, kv_bytes=kv_bytes,
                                      batch=len(lengths), n_heads=G * R,
                                      q_bytes=q.element_size(), max_pages=M)
        flops = 4.0 * tokens * G * R * hd
        peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
        t_b, t_o = nbytes / HBM_BW, flops / peak
        bound, by = 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o
                                          else "operations")
        rows.append(dict(name=c["name"], max_abs_err=err, tol=tol, ms=kern,
                         plain_ms=plain, library_ms=None, bound_ms=bound,
                         bound_by=by, live_pages=live))
        print(f"paged_attention {c['name']}: max_abs_err={err:.3g} "
              f"(tol {tol:.3g}) ms={kern:.4f} plain_ms={plain:.4f} "
              f"library_ms=null bound_ms={bound:.5f} ({by}, "
              f"{live} live pages)")
    return rows


def phi4_paged_cases(dtype_main):
    import torch
    lengths = [0, 15, 16, 17, 100, 255, 400, 1000]     # 8 slots, ragged
    base = dict(G=8, R=3, hd=128, P=16, M=64, lengths=lengths)
    return [
        dict(base, name="bf16", dtype=dtype_main, int8=False),
        dict(base, name="int8", dtype=dtype_main, int8=True),
        dict(base, name="fp32", dtype=torch.float32, int8=False),
        dict(base, name="fp32-int8", dtype=torch.float32, int8=True),
        dict(base, name="softcap+window", dtype=torch.float32, int8=False,
             cap=50.0, window=128),
    ]


# ---------------------------------------------------------------- parity --

def engine_streams(cfg, params, table, device, rung, prompts, max_new):
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(cfg, batch_slots=2, max_len=64, params=params,
                      table=table, prefill_chunk=4, page_size=4, n_pages=24,
                      device=device)
    eng.request_variant(rung)
    reqs = [Request(i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs]


def check_parity(device):
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serving_table
    from repro_torch.models.lm import init_lm
    cfg = get_config("phi4-mini-3.8b-smoke")
    cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
    dev_params = copy.deepcopy(cpu_params).to(device)
    table = serving_table(cfg, slots=2, max_len=64, page_occupancy=0.5)
    rng = np.random.default_rng(3)
    prefix = list(rng.integers(1, cfg.vocab_size, 8))
    prompts = [prefix + list(rng.integers(1, cfg.vocab_size, n))
               for n in (3, 9, 5, 13)]
    for rung, v in enumerate(table.variants):
        a = engine_streams(cfg, dev_params, table, device, rung, prompts, 6)
        b = engine_streams(cfg, cpu_params, table, torch.device("cpu"), rung,
                           prompts, 6)
        assert a == b, (v.name, a, b)
        print(f"parity {v.name}: {device} streams == cpu streams "
              f"({sum(map(len, a))} tokens)")


COUNTERS = ("flash_attention", "int8_matmul", "paged_attention",
            "ssd_scan")


def _kernel_mods():
    from repro_torch.kernels import flash_attention, int8_matmul, \
        paged_attention, ssd_scan
    return {"flash_attention": flash_attention, "int8_matmul": int8_matmul,
            "paged_attention": paged_attention, "ssd_scan": ssd_scan}


def reset_launches():
    for mod in _kernel_mods().values():
        mod.launches = 0


def read_launches():
    return {name: mod.launches for name, mod in _kernel_mods().items()}


def mamba_launches(cfg, knobs):
    """Kernel launches of one mamba2 training step without remat: every
    layer's ``ssd_scan`` once; on the int8 rungs each of its three int8
    projections once forward and once backward (the exact int32 sums the
    scales' gradients need)."""
    L = cfg.n_layers
    return {"ssd_scan": L, "flash_attention": 0, "paged_attention": 0,
            "int8_matmul": 6 * L if knobs.matmul_precision == "int8" else 0}


def attn_launches(cfg, knobs):
    """Kernel launches of one dense-attention training step under remat
    "full": the attention runs forward once and again in the recompute, on
    the kernel unless the stride knob perforates it (``_causal_chunked``
    in plain PyTorch); on the int8 rungs each of the MLP's three products
    runs forward, again in the recompute and once in the backward."""
    L = cfg.n_layers
    return {"ssd_scan": 0, "paged_attention": 0,
            "flash_attention": 2 * L if knobs.kv_keep_stride <= 1 else 0,
            "int8_matmul": 9 * L if knobs.matmul_precision == "int8" else 0}


def check_train_parity(device, arch="mamba2-780m-smoke", steps=3,
                       batch=4, seq=32, remat="none", per_step=None):
    """``arch`` trained in fp32 from the same seeded weights, once on the
    card (CUDA kernels, forward and backward) and once on the CPU (plain
    versions), ``steps`` steps on each rung of the training ladder: every
    step's loss within 1e-4 relative (fp32 sums in other orders, carried
    through three AdamW steps). The card run's launches must be
    ``per_step(cfg, knobs)`` a step."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.explorer import explore
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.lm import init_lm
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    cfg = get_config(arch)
    table = explore(cfg, ShapeConfig("cli", seq, batch, "train"),
                    serving=False, max_variants=4)
    cpu_params = init_lm(cfg, 0, torch.float32, "cpu")
    src = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    opt_cfg = optim.OptConfig(lr=1e-3, warmup=2, total_steps=10)
    worst = 0.0
    for v in table.variants:
        losses = []
        for d in (device, torch.device("cpu")):
            params = copy.deepcopy(cpu_params).to(d)
            opt = optim.init_opt(params)
            step = make_train_step(cfg, v.knobs, opt_cfg=opt_cfg,
                                   remat=remat)
            losses.append([])
            reset_launches()
            for i in range(steps):
                tokens = torch.as_tensor(src.batch(i), device=d)
                params, opt, m = step(params, opt, {"tokens": tokens})
                losses[-1].append(float(m["loss"]))
            if d == device:
                launches = read_launches()
        want = {k: steps * n for k, n in per_step(cfg, v.knobs).items()}
        rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        worst = max(worst, rel)
        print(f"train parity {arch} {v.name}: {device} losses "
              f"{[round(x, 6) for x in losses[0]]} vs cpu "
              f"{[round(x, 6) for x in losses[1]]} (max rel {rel:.3g}), "
              f"card launches {launches}")
        assert rel <= 1e-4, (v.name, losses)
        assert launches == want, (v.name, launches, want)
    return worst


# ------------------------------------------------------------- full width --

def serve_full(device, arch="phi4-mini-3.8b", requests=12, slots=8):
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--paged", "--dtype", "bf16",
            "--device", str(device), "--slots", str(slots),
            "--max-len", "1024", "--page-size", "16",
            "--prefill-chunk", "128", "--requests", str(requests),
            "--prompt-len", "64", "--prompt-len-max", "400",
            "--max-new", "16", "--qos-target", "0.001",
            "--decision-interval", "0", "--min-samples", "4"]
    reset_launches()
    res = serve.main(argv)
    launches = read_launches()
    eng, reqs = res["engine"], res["requests"]
    vocab = eng.cfg.vocab_size
    assert all(r.done and len(r.out) == r.max_new for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < vocab for r in reqs for t in r.out)
    visited = {0} | {v for _, v in eng.swaps}
    names = res["names"]
    assert names == ["precise", "int8", "int8+kvq8"], names
    assert {0, len(names) - 1} <= visited, (eng.swaps, names)
    assert launches["int8_matmul"] > 0 and launches["paged_attention"] > 0 \
        and launches["flash_attention"] == launches["ssd_scan"] == 0, \
        launches
    print(f"serve {arch}: {res['tokens']} tokens, "
          f"tok_s={res['tok_s']:.2f} p50_ms={1e3 * res['p50_s']:.3f} "
          f"p99_ms={1e3 * res['p99_s']:.3f} swaps={eng.swaps} "
          f"launches={launches}")
    return res, launches


def rung_walk(res, device, batch=8, prompt_len=128, max_new=16):
    """Explicit ``request_variant`` walk over the ladder on the full-width
    weights: each rung serves ``batch`` requests; the median decode step
    is reported per rung."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    src = res["engine"]
    rng = np.random.default_rng(1)
    out = {}
    for rung, name in enumerate(res["names"]):
        eng = ServeEngine(src.cfg, batch_slots=batch, max_len=1024,
                          params=src.params, table=src.table,
                          prefill_chunk=128, page_size=16,
                          cache_dtype=src.cache_dtype, device=device)
        eng.request_variant(rung)
        assert eng.active_variant == rung
        reqs = [Request(i, prompt=list(rng.integers(
            1, src.cfg.vocab_size, prompt_len)), max_new=max_new)
            for i in range(batch)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        step_ms = 1e3 * float(np.median(eng.step_latencies))
        out[name] = step_ms
        print(f"rung {name}: median decode step {step_ms:.3f} ms "
              f"({batch} slots, prompt {prompt_len}, "
              f"{len(eng.step_latencies)} steps)")
    return out


def profile_rungs(res, device, batch=8, prompt_len=128, steps=8):
    """``torch.profiler`` over ``steps`` decode steps of a full batch on each
    rung of the full-width model: wall and device-busy time per step, and
    the kernels that took the most device time. Only the card's activity is
    traced (host-side tracing of every operator costs more than the step)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request, ServeEngine

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    src = res["engine"]
    rng = np.random.default_rng(2)
    for rung, name in enumerate(res["names"]):
        eng = ServeEngine(src.cfg, batch_slots=batch, max_len=1024,
                          params=src.params, table=src.table,
                          prefill_chunk=128, page_size=16,
                          cache_dtype=src.cache_dtype, device=device)
        eng.request_variant(rung)
        for i in range(batch):
            eng.submit(Request(i, prompt=list(rng.integers(
                1, src.cfg.vocab_size, prompt_len)), max_new=steps + 32))
        while not all(s is not None for s in eng.slots):
            eng.step()
        eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kern) / 1e3 / steps
        print(f"profile {name}: {batch} slots, {steps} decode steps, "
              f"wall {1e3 * wall / steps:.3f} ms/step, device busy "
              f"{busy:.3f} ms/step ({busy / (1e3 * wall / steps):.3f})")
        for e in sorted(kern, key=dev_us, reverse=True)[:10]:
            print(f"  {dev_us(e) / 1e3 / steps:9.3f} ms/step "
                  f"{e.count / steps:6.1f} calls/step  {e.key[:90]}")


def train_full(device, arch, steps, batch, seq, names, per_step,
               remat="none"):
    """A training slice at full width and depth:
    ``repro_torch.launch.train.main`` on ``arch`` (fp32 params, random
    weights from a seed) under ``--pliant``, decisions every step, so the
    burst in the middle of the run walks the ladder ``names`` down and
    back. The kernels' launch counters are zeroed just before and read just
    after, and must equal ``per_step(cfg, knobs)`` summed over the rungs
    the run took."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--pliant", "--decision-interval", "0",
            "--device", str(device)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = train.main(argv, remat=remat)
    launches = read_launches()
    cfg, table = res["cfg"], res["table"]
    assert res["names"] == names, res["names"]
    assert set(res["variants"]) == set(range(len(names))), res["variants"]
    assert all(np.isfinite(res["losses"])), res["losses"]
    want = dict.fromkeys(COUNTERS, 0)
    for v in res["variants"]:
        for k, n in per_step(cfg, table.variants[v].knobs).items():
            want[k] += n
    walk = [names[v] for v in res["variants"]]
    print(f"train {arch}: {steps} steps batch {batch} seq {seq} remat "
          f"{remat}, losses {[round(x, 4) for x in res['losses']]}, rungs "
          f"{walk}, step_s {[round(x, 3) for x in res['step_s']]}, data "
          f"wait s {[round(x, 4) for x in res['wait_s']]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches={launches}")
    assert launches == want, (launches, want)
    return res, launches


def train_rung_walk(res, device, steps=8, per_step=None, skip=1,
                    rungs=None, tag=""):
    """Each rung (or those named in ``rungs``) pinned by
    ``table.executable(i)`` on the full-width state: ``steps`` steps, the
    median of all but the first ``skip`` (and their spread), the peak
    device memory of those steps, and the kernel launches a step (held to
    ``per_step``). ``tag`` follows the rung's name in the report."""
    import numpy as np
    import torch
    table, src, cfg = res["table"], res["source"], res["cfg"]
    params, opt = res["params"], res["opt"]
    out = {}
    for i, name in enumerate(res["names"]):
        if rungs is not None and name not in rungs:
            continue
        step = table.executable(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times = []
        for k in range(steps):
            tokens = torch.as_tensor(src.batch(100 + k), device=device)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, {"tokens": tokens})
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per = {k: n / steps for k, n in read_launches().items() if n}
        want = {k: n for k, n in per_step(cfg, table.variants[i].knobs
                                          ).items() if n}
        kept = times[skip:]
        ms = 1e3 * float(np.median(kept))
        out[name] = dict(step_ms=ms, peak_gib=peak, launches=per)
        print(f"train rung {cfg.name} {name}{tag}: median step {ms:.1f} ms "
              f"over "
              f"{len(kept)} steps (range {1e3 * min(kept):.1f}-"
              f"{1e3 * max(kept):.1f}, first {1e3 * times[0]:.1f} ms), "
              f"peak {peak:.2f} GiB, launches a step {per}")
        assert per == want, (name, per, want)
    res["params"], res["opt"] = params, opt
    return out


def chunked_causal_attention():
    """A context in which the model's causal attention at stride 1 runs
    ``_causal_chunked`` at stride 1 (plain PyTorch: what the perforated
    rung runs, less the perforation) in place of the kernel, so that the
    stride rung's change of step time splits into the swap of kernel for
    plain PyTorch and the perforation itself."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.models import attention as am
    flash = ops.flash

    def chunked(q, k, v, *, causal=True, window=0, cap=0.0,
                kv_keep_stride=1):
        if not causal or window or kv_keep_stride > 1:
            return flash(q, k, v, causal=causal, window=window, cap=cap,
                         kv_keep_stride=kv_keep_stride)
        B, H, S, hd = q.shape
        G = k.shape[1]
        o = am._causal_chunked(
            q.transpose(1, 2).reshape(B, S, G, H // G, hd),
            k.transpose(1, 2), v.transpose(1, 2),
            q_chunk=am.default_q_chunk(S), kv_keep_stride=1, cap=cap)
        return o.reshape(B, S, H, hd).transpose(1, 2)
    return mock.patch.object(ops, "flash", chunked)


def time_attention_paths(device, B=2, S=4096, H=24, KVH=8, hd=128,
                         layers=32, iters=3):
    """One layer's attention core at phi4-mini's training cell (fp32,
    causal), from the model's (B, S, H, hd) layout, three ways: the kernel
    through ``ops.flash`` (the precise and int8 rungs), and
    ``_causal_chunked`` at stride 1 and at stride 2 (int8+kvstride2). Each
    is timed forward alone (remat's first pass, which saves nothing) and
    forward with backward (the recompute and the VJP): a step spends
    ``layers`` x (forward + forward-and-backward). Kernel against chunked
    stride 1 is the stride rung's swap of kernel for plain PyTorch;
    chunked stride 1 against stride 2 its perforation. The kernel's and
    chunked stride 1's outputs are held to each other (FP32_ATOL)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention as am
    q, k, v = (t.transpose(1, 2).contiguous() for t in flash_case(
        B, H, KVH, S, S, hd, torch.float32, device, seed=1))
    go = torch.randn(B, S, H, hd, device=device,
                     generator=torch.Generator(device=device).manual_seed(2))

    def kernel(q, k, v):
        return ops.flash(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True).transpose(1, 2)

    def chunked(stride):
        return lambda q, k, v: am._causal_chunked(
            q.reshape(B, S, KVH, H // KVH, hd), k, v,
            q_chunk=am.default_q_chunk(S), kv_keep_stride=stride,
            cap=0.0).reshape(B, S, H, hd)

    paths = {"kernel": kernel, "chunked stride 1": chunked(1),
             "chunked stride 2": chunked(2)}
    with torch.no_grad():
        err = max_err(kernel(q, k, v), paths["chunked stride 1"](q, k, v))
    assert err <= FP32_ATOL, err
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = {}
    for name, fn in paths.items():
        def fwd():
            with torch.no_grad():
                fn(q, k, v)

        def fwd_bwd():
            fn(*leaves).backward(go)
        f, fb = timed(fwd, device, iters, 1), timed(fwd_bwd, device, iters, 1)
        out[name] = dict(fwd_ms=f, fwd_bwd_ms=fb,
                         step_ms=layers * (f + fb))
        print(f"attention core {name}: forward {f:.3f} ms, forward+backward "
              f"{fb:.3f} ms, {layers} layers under remat "
              f"{layers * (f + fb):.1f} ms a step")
    print(f"attention core: kernel vs chunked stride 1 max_abs_err "
          f"{err:.3g} (tol {FP32_ATOL:.3g})")
    return out


def profile_train(res, device):
    """``torch.profiler`` over one training step per rung at full width,
    the card's activity only: wall and device-busy time, the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    table, src = res["table"], res["source"]
    params, opt = res["params"], res["opt"]
    for i, name in enumerate(res["names"]):
        step = table.executable(i)
        tokens = torch.as_tensor(src.batch(200 + i), device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, {"tokens": tokens})
            float(m["loss"])
            wall = 1e3 * (time.perf_counter() - t0)
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kern) / 1e3
        print(f"train profile {res['cfg'].name} {name}: wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms ({busy / wall:.3f}), peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        for e in sorted(kern, key=dev_us, reverse=True)[:12]:
            print(f"  {dev_us(e) / 1e3:9.3f} ms {e.count:6d} calls  "
                  f"{e.key[:90]}")
    res["params"], res["opt"] = params, opt


# ------------------------------------------------------------------ main --

def main():
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's src/repro_torch is missing",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {secs:.2f}s for {', '.join(_build.SOURCES)}")
    for name, log in _build.ptxas_log.items():
        seen = dict.fromkeys(line.split(":", 1)[-1].strip()
                             for line in log.splitlines()
                             if "registers" in line or "spill" in line)
        for line in seen:
            print(f"  {name}: {line}")

    t = time.perf_counter()

    def phase_done(name):
        nonlocal t
        print(f"phase {name}: {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()

    shapes = [(m, k, n) for m in (1, 8, 128)
              for k, n in ((3072, 8192), (8192, 3072))] + [(5, 3000, 1000)]
    # mamba2-780m training: the projections at 4 x 1024 tokens
    shapes += [(4096, 1536, 3072), (4096, 3072, 1536)]
    i8_rows = check_int8(device, shapes)
    pa_rows = check_paged(device, phi4_paged_cases(torch.bfloat16))
    ssd_full = (4, 1024, 48, 64, 128, 128)      # mamba2-780m training
    ssd_rows = check_ssd(device, [(2, 64, 8, 16, 16, 16), ssd_full])
    # the token-drop rungs' batch rows: int8+drop12% keeps 3, int8+drop50% 2
    check_ssd(device, [(3,) + ssd_full[1:], (2,) + ssd_full[1:]],
              dtypes=(torch.float32,))
    check_ssd_grads(device)
    ssd_bwd_ms = time_ssd_backward(device, ssd_full)
    check_int8_grads(device)
    fa_rows = check_flash(device, phi4_flash_cases())
    check_flash_grads(device)
    time_attention_paths(device)
    kernels = {"flash_attention": next(r for r in fa_rows
                                       if r["name"] == "cell-fp32"),
               "int8_matmul": next(r for r in i8_rows
                                   if (r["M"], r["K"], r["N"])
                                   == (8, 3072, 8192)),
               "paged_attention": next(r for r in pa_rows
                                       if r["name"] == "bf16"),
               "ssd_scan": next(r for r in ssd_rows
                                if r["shape"] == ssd_full
                                and r["dtype"] == "fp32")}
    phase_done("kernels")
    check_parity(device)
    check_train_parity(device, per_step=mamba_launches)
    check_train_parity(device, "phi4-mini-3.8b-smoke", batch=2, seq=4096,
                       remat="full", per_step=attn_launches)
    phase_done("parity")
    res, serve_launches = serve_full(device)
    rung_walk(res, device)
    phase_done("serve")
    profile_rungs(res, device)
    phase_done("profile")
    del res
    torch.cuda.empty_cache()
    tres, train_launches = train_full(
        device, "mamba2-780m", 12, 4, 1024,
        ["precise", "int8", "int8+drop12%", "int8+drop50%"], mamba_launches)
    phase_done("train")
    train_rung_walk(tres, device, steps=5, per_step=mamba_launches)
    profile_train(tres, device)
    phase_done("train-rungs")
    print(f"ssd_scan_backward: {48 * ssd_bwd_ms:.1f} ms a training step "
          f"(48 layers x {ssd_bwd_ms:.3f} ms)")
    del tres
    torch.cuda.empty_cache()
    # phi4-mini-3.8b at 2 x 4096 tokens: 61.5 GB of fp32 params, grads and
    # AdamW moments, so the layers' activations fit only under remat
    ares, attn_train_launches = train_full(
        device, "phi4-mini-3.8b", 8, 2, 4096,
        ["precise", "int8", "int8+kvstride2", "int8+drop50%"],
        attn_launches, remat="full")
    phase_done("train-attn")
    train_rung_walk(ares, device, steps=4, per_step=attn_launches)
    with chunked_causal_attention():
        train_rung_walk(ares, device, steps=4, rungs=["int8"],
                        tag=" (attention chunked, stride 1)",
                        per_step=lambda cfg, knobs: {
                            **attn_launches(cfg, knobs),
                            "flash_attention": 0})
    profile_train(ares, device)
    phase_done("train-attn-rungs")

    src_of = {"flash_attention": (
                  "src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:89"),
              "int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                              "src/repro/kernels/int8_matmul.py:40"),
              "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:98"),
              "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:62")}
    by_path = {name: {"serve": serve_launches[name],
                      "train": train_launches[name],
                      "train-attn": attn_train_launches[name]}
               for name in kernels}
    line = []
    for name, r in kernels.items():
        line.append(dict(name=name, route="cuda", source=src_of[name][0],
                         replaces=src_of[name][1],
                         launches=sum(by_path[name].values()),
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"],
                         launches_by_path=by_path[name]))
    print(json.dumps({"kernels": line}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
