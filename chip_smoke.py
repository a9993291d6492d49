#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py            # needs one CUDA card

Phases, each reported on its own line:

1. build     nvcc builds every kernel of the serving path from ``csrc/``.
2. kernels   each kernel against its plain PyTorch version on the card, at
             the shapes the serving path gives it (phi4-mini-3.8b widths),
             with its time beside the plain version's, a library call's
             where one computes the same function, and its bound.
3. parity    phi4-mini-3.8b-smoke served in fp32 twice from the same seeded
             weights, once on the card (CUDA kernels) and once on the CPU
             (plain versions): the greedy token streams of each rung of the
             serving ladder must be equal.
4. serve     the slice at full width: ``repro_torch.launch.serve.main`` on
             phi4-mini-3.8b (32 layers, bf16 weights and cache, random
             weights from a seed) under a QoS target tight enough that the
             Pliant runtime swaps variants; the kernels' launch counters are
             zeroed just before and read just after. Then an explicit
             ``request_variant`` walk serves a batch on each rung and times
             its decode steps.
5. profile   ``torch.profiler`` over decode steps of a full batch on each
             rung: wall and device-busy time per step, the largest kernels.

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
    i8_rows = check_int8(device, shapes)
    pa_rows = check_paged(device, phi4_paged_cases(torch.bfloat16))
    kernels = {"int8_matmul": next(r for r in i8_rows
                                   if (r["M"], r["K"], r["N"])
                                   == (8, 3072, 8192)),
               "paged_attention": next(r for r in pa_rows
                                       if r["name"] == "bf16")}
    phase_done("kernels")
    check_parity(device)
    phase_done("parity")
    res, launches = serve_full(device)
    rung_walk(res, device)
    phase_done("serve")
    profile_rungs(res, device)
    phase_done("profile")

    src_of = {"int8_matmul": ("src/repro_torch/csrc/int8_matmul.cu",
                              "src/repro/kernels/int8_matmul.py:40"),
              "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                  "src/repro/kernels/paged_attention.py:98")}
    line = []
    for name, r in kernels.items():
        line.append(dict(name=name, route="cuda", source=src_of[name][0],
                         replaces=src_of[name][1],
                         launches=launches[name],
                         max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
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
