#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py            # needs one CUDA card

Phases, each reported on its own line:

1. build     nvcc builds every kernel of the port from ``csrc/``, one
             process per source, all at once.
2. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes its path gives it (phi4-mini-3.8b serving widths;
             mamba2-780m training widths for ``ssd_scan`` and the int8
             projections), fp32 and bf16, with its time beside the plain
             version's, a library call's where one computes the same
             function, and its bound. Then the training path's gradients:
             ``SSDScan`` (kernel forward, VJP of the chunked twin) against
             autograd through ``ssd_chunked_ref`` on the CPU, the backward's
             time at the training shape, and the differentiable
             ``quantized_matmul``'s gradients (zero pattern included)
             against the CPU plain path.
3. parity    phi4-mini-3.8b-smoke served in fp32 twice from the same seeded
             weights, on the card and on the CPU: the greedy token streams
             of each serving rung must be equal. mamba2-780m-smoke trained
             in fp32 three steps on each training rung, on the card and on
             the CPU from the same weights: the losses must agree.
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


def check_train_parity(device, arch="mamba2-780m-smoke", steps=3,
                       batch=4, seq=32):
    """mamba2-780m-smoke trained in fp32 from the same seeded weights, once
    on the card (CUDA kernels, forward and backward) and once on the CPU
    (plain versions), ``steps`` steps on each rung of the training ladder:
    every step's loss within 1e-4 relative (fp32 sums in other orders,
    carried through three AdamW steps)."""
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
                                   remat="none")
            losses.append([])
            for i in range(steps):
                tokens = torch.as_tensor(src.batch(i), device=d)
                params, opt, m = step(params, opt, {"tokens": tokens})
                losses[-1].append(float(m["loss"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
        worst = max(worst, rel)
        assert rel <= 1e-4, (v.name, losses)
        print(f"train parity {v.name}: {device} losses "
              f"{[round(x, 6) for x in losses[0]]} vs cpu "
              f"{[round(x, 6) for x in losses[1]]} (max rel {rel:.3g})")
    return worst


# ------------------------------------------------------------- full width --

def serve_full(device, arch="phi4-mini-3.8b", requests=12, slots=8):
    import numpy as np
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--paged", "--dtype", "bf16",
            "--device", str(device), "--slots", str(slots),
            "--max-len", "1024", "--page-size", "16",
            "--prefill-chunk", "128", "--requests", str(requests),
            "--prompt-len", "64", "--prompt-len-max", "400",
            "--max-new", "16", "--qos-target", "0.001",
            "--decision-interval", "0", "--min-samples", "4"]
    i8.launches = pa.launches = 0
    res = serve.main(argv)
    launches = {"int8_matmul": i8.launches, "paged_attention": pa.launches}
    eng, reqs = res["engine"], res["requests"]
    vocab = eng.cfg.vocab_size
    assert all(r.done and len(r.out) == r.max_new for r in reqs), \
        [(r.uid, r.done, len(r.out)) for r in reqs]
    assert all(0 <= t < vocab for r in reqs for t in r.out)
    visited = {0} | {v for _, v in eng.swaps}
    names = res["names"]
    assert names == ["precise", "int8", "int8+kvq8"], names
    assert {0, len(names) - 1} <= visited, (eng.swaps, names)
    assert all(n > 0 for n in launches.values()), launches
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
    the kernels that took the most device time."""
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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


def train_full(device, arch="mamba2-780m", steps=12, batch=4, seq=1024):
    """The training slice at full width and depth:
    ``repro_torch.launch.train.main`` on mamba2-780m (48 layers, fp32
    params, random weights from a seed) under ``--pliant``, decisions every
    step, so the burst in the middle of the run walks the ladder down and
    back. The kernels' launch counters are zeroed just before and read just
    after: every layer launches ``ssd_scan`` once a step, and on the int8
    rungs each of its three int8 projections launches ``int8_matmul`` once
    forward and once backward (the exact int32 sums for the scales'
    gradients)."""
    import numpy as np
    import torch
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import train
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--pliant", "--decision-interval", "0",
            "--device", str(device)]
    torch.cuda.reset_peak_memory_stats()
    i8.launches = ss.launches = 0
    res = train.main(argv)
    launches = {"ssd_scan": ss.launches, "int8_matmul": i8.launches}
    cfg, names = res["cfg"], res["names"]
    n_int8 = sum(res["table"].variants[v].knobs.matmul_precision == "int8"
                 for v in res["variants"])
    assert names == ["precise", "int8", "int8+drop12%", "int8+drop50%"], \
        names
    assert set(res["variants"]) == set(range(len(names))), res["variants"]
    assert all(np.isfinite(res["losses"])), res["losses"]
    assert launches["ssd_scan"] == cfg.n_layers * steps, launches
    assert launches["int8_matmul"] == 6 * cfg.n_layers * n_int8 > 0, \
        (launches, n_int8)
    walk = [names[v] for v in res["variants"]]
    print(f"train {arch}: {steps} steps batch {batch} seq {seq}, losses "
          f"{[round(x, 4) for x in res['losses']]}, rungs {walk}, "
          f"step_s {[round(x, 3) for x in res['step_s']]}, data wait s "
          f"{[round(x, 4) for x in res['wait_s']]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches={launches}")
    return res, launches


def train_rung_walk(res, device, steps=8):
    """Each rung pinned by ``table.executable(i)`` on the full-width state:
    ``steps`` steps, the median of all but the first (and their spread),
    and the peak device memory of those steps."""
    import numpy as np
    import torch
    table, src = res["table"], res["source"]
    params, opt = res["params"], res["opt"]
    out = {}
    for i, name in enumerate(res["names"]):
        step = table.executable(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for k in range(steps):
            tokens = torch.as_tensor(src.batch(100 + k), device=device)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, {"tokens": tokens})
            float(m["loss"])
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = 1e3 * float(np.median(times[1:]))
        out[name] = dict(step_ms=ms, peak_gib=peak)
        print(f"train rung {name}: median step {ms:.1f} ms over "
              f"{steps - 1} steps (range {1e3 * min(times[1:]):.1f}-"
              f"{1e3 * max(times[1:]):.1f}, first {1e3 * times[0]:.1f} ms), "
              f"peak {peak:.2f} GiB")
    res["params"], res["opt"] = params, opt
    return out


def profile_train(res, device):
    """``torch.profiler`` over one training step per rung at full width:
    wall and device-busy time, the largest kernels."""
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, {"tokens": tokens})
            float(m["loss"])
            wall = 1e3 * (time.perf_counter() - t0)
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kern) / 1e3
        print(f"train profile {name}: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms ({busy / wall:.3f})")
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
    kernels = {"int8_matmul": next(r for r in i8_rows
                                   if (r["M"], r["K"], r["N"])
                                   == (8, 3072, 8192)),
               "paged_attention": next(r for r in pa_rows
                                       if r["name"] == "bf16"),
               "ssd_scan": next(r for r in ssd_rows
                                if r["shape"] == ssd_full
                                and r["dtype"] == "fp32")}
    phase_done("kernels")
    check_parity(device)
    check_train_parity(device)
    phase_done("parity")
    res, serve_launches = serve_full(device)
    rung_walk(res, device)
    phase_done("serve")
    profile_rungs(res, device)
    phase_done("profile")
    del res
    torch.cuda.empty_cache()
    tres, train_launches = train_full(device)
    phase_done("train")
    train_rung_walk(tres, device)
    profile_train(tres, device)
    phase_done("train-rungs")
    print(f"ssd_scan_backward: {48 * ssd_bwd_ms:.1f} ms a training step "
          f"(48 layers x {ssd_bwd_ms:.3f} ms)")

    src_of = {"int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                              "src/repro/kernels/int8_matmul.py:40"),
              "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:98"),
              "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                           "src/repro/kernels/ssd_scan.py:62")}
    by_path = {name: {"serve": serve_launches.get(name, 0),
                      "train": train_launches.get(name, 0)}
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
