#!/usr/bin/env python3
"""Measure the port's ``ssd_scan`` kernels on one NVIDIA card.

  python3 tools/ssd_scan_bench.py measure [--train]
      In the checkout that is the current directory (any tree whose
      ``chip_smoke.py`` has ``check_ssd``, ``time_ssd_backward``,
      ``train_full``, ``train_rung_walk`` and ``profile_train``): the
      forward against its plain version at mamba2-780m's training shape
      (B 4, S 1024, H 48, P 64, N 128, Q 128; fp32 and bf16), the
      backward's time and peak extra memory, and with ``--train``
      mamba2-780m training on every rung (12 steps under ``--pliant``,
      then 5 pinned steps a rung and one profiled step a rung).
  python3 tools/ssd_scan_bench.py compare PARENT_DIR
      ``measure --train`` in PARENT_DIR (a checkout of another commit,
      e.g. unpacked with ``git archive``) and here, then ``measure`` here
      and in PARENT_DIR: the kernels in turns, parent / change / change /
      parent, on one card.
  python3 tools/ssd_scan_bench.py passes
      Device time of each pass of the forward and the backward at the
      training shape (``torch.profiler``, 10 calls each).
  python3 tools/ssd_scan_bench.py unit
      The kernels' 64 x 64 product unit alone, its loop run on operands
      resident in shared memory, for each pair of operand layouts and 4 to
      16 blocks an SM: the unit's own rate, without staging, barriers or
      epilogues.
  python3 tools/ssd_scan_bench.py ab SOURCE.cu [SOURCE.cu ...]
      Variants of ``csrc/ssd_scan.cu``, each built with the port's nvcc
      flags into ``build/ssd_ab/`` and run through the wrapper's entry
      points: errors against the plain versions, forward and backward
      times in turns (v0 .. vn vn .. v0) and per-pass times.

Every mode prints the card's name and power limit. Needs CUDA; run it from
the repository's root (``compare`` and ``measure`` from a checkout's).
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

TRAIN_SHAPE = (4, 1024, 48, 64, 128, 128)   # B, S, H, P, N, Q
RUNGS = ["precise", "int8", "int8+drop12%", "int8+drop50%"]


def smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(out.splitlines()[0], flush=True)


def _setup():
    import torch
    sys.path[:0] = ["src", "."]
    if not torch.cuda.is_available():
        sys.exit("ssd_scan_bench: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    print(f"build {_build.build_all():.1f}s", flush=True)
    smi()
    return torch.device("cuda", 0)


def measure(train: bool):
    dev = _setup()
    import chip_smoke as cs
    cs.check_ssd(dev, [TRAIN_SHAPE])
    cs.time_ssd_backward(dev, TRAIN_SHAPE)
    if train:
        res, _ = cs.train_full(dev, "mamba2-780m", 12, 4, 1024, RUNGS,
                               cs.mamba_launches)
        cs.train_rung_walk(res, dev, steps=5, per_step=cs.mamba_launches)
        cs.profile_train(res, dev)
    smi()


def compare(parent: str):
    me = pathlib.Path(__file__).resolve()
    here = pathlib.Path.cwd()
    for cwd, args in ((parent, ["--train"]), (here, ["--train"]),
                      (here, []), (parent, [])):
        print(f"== measure {' '.join(args)} in "
              f"{'parent' if cwd == parent else 'this checkout'}",
              flush=True)
        subprocess.run([sys.executable, str(me), "measure", *args],
                       cwd=cwd, check=True)


def _per_pass(mod, x, dt, a, b, c, gy, Q, n=10):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        mod.ssd_scan(x, dt, a, b, c, chunk=Q)
        mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            mod.ssd_scan(x, dt, a, b, c, chunk=Q)
            mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or \
            getattr(e, "self_cuda_time_total", 0)
        if us:
            name = e.key.split("::")[-1].split("(")[0]
            rows.append((us / 1e3 / e.count, e.count // n, name))
    return sorted(rows, reverse=True)


def _inputs(dev):
    import chip_smoke as cs
    import torch
    B, S, H, P, N, Q = TRAIN_SHAPE
    x, dt, a, b, c = cs.ssd_case(B, S, H, P, N, torch.float32, dev)
    gy = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(1))
    return x, dt, a, b, c, gy, Q


def passes():
    dev = _setup()
    from repro_torch.kernels import ssd_scan as mod
    x, dt, a, b, c, gy, Q = _inputs(dev)
    print(f"ms a launch at {TRAIN_SHAPE} (B, S, H, P, N, Q), launches a "
          "forward + backward:")
    for ms, per, name in _per_pass(mod, x, dt, a, b, c, gy, Q):
        print(f"  {ms:8.4f} ms  x{per}  {name}")


UNIT_SRC = r'''
#include "{src}"

template <bool AKC, bool BKC>
__global__ void __launch_bounds__(UNIT) unit_loop(float* out, int iters) {
  extern __shared__ __align__(16) float sm[];
  constexpr int AF = AKC ? kc_floats(TILE) : km_floats(TILE);
  constexpr int BF = BKC ? kc_floats(TILE) : km_floats(TILE);
  for (int i = threadIdx.x; i < AF + BF; i += UNIT) sm[i] = 1e-3f * (i % 7);
  __syncthreads();
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  float acc[8][8];
  zero(acc);
  for (int it = 0; it < iters; ++it)
    mma<AKC, BKC>(acc, sm, AKC ? KC_LD : TILE + 4, sm + AF,
                  BKC ? KC_LD : TILE + 4, ty, tx, 0, KCH);
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * UNIT + threadIdx.x] = s;
}

template <bool AKC, bool BKC>
float time_loop(int blocks, int iters, float* out) {
  const size_t smem = sizeof(float) * 2 * kc_floats(TILE);
  cudaFuncSetAttribute(unit_loop<AKC, BKC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  unit_loop<AKC, BKC><<<blocks, UNIT, smem>>>(out, iters);
  cudaEventRecord(e0);
  unit_loop<AKC, BKC><<<blocks, UNIT, smem>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

extern "C" int unit_bench(int blocks, int iters, float* ms) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * UNIT);
  ms[0] = time_loop<true, true>(blocks, iters, out);
  ms[1] = time_loop<true, false>(blocks, iters, out);
  ms[2] = time_loop<false, false>(blocks, iters, out);
  cudaFree(out);
  return (int)cudaGetLastError();
}
'''


def _nvcc(src: pathlib.Path, so: pathlib.Path):
    from repro_torch.kernels import _build
    return subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def unit():
    _setup()
    from repro_torch.kernels import _build
    out = pathlib.Path("build") / "ssd_ab"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "unit_bench.cu"
    src.write_text(UNIT_SRC.replace(
        "{src}", str((_build.CSRC / "ssd_scan.cu").resolve())))
    p = _nvcc(src, out / "unit_bench.so")
    log, _ = p.communicate()
    assert p.returncode == 0, log
    lib = ctypes.CDLL(str(out / "unit_bench.so"))
    fp32_peak = 67e12
    for per_sm in (4, 8, 16):
        blocks, iters = 132 * per_sm, 2000
        ms = (ctypes.c_float * 3)()
        assert lib.unit_bench(blocks, iters, ms) == 0
        flop = 2.0 * blocks * 64 * 64 * 32 * iters
        print(f"{per_sm:2d} blocks an SM: " + "  ".join(
            f"{name} {flop / (t * 1e-3) / 1e12:.1f} TFLOP/s "
            f"({flop / (t * 1e-3) / fp32_peak:.2f} of peak)"
            for name, t in zip(("A,B k-contiguous", "A k-contiguous, B "
                                "k-major", "A,B k-major"), ms)))


def ab(sources):
    dev = _setup()
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as mod
    out = pathlib.Path("build") / "ssd_ab"
    out.mkdir(parents=True, exist_ok=True)
    built = [(pathlib.Path(s), out / (pathlib.Path(s).stem + ".so"))
             for s in sources]
    procs = [(src, so, _nvcc(src, so)) for src, so in built]
    libs = {}
    for src, so, p in procs:
        log, _ = p.communicate()
        assert p.returncode == 0, log
        lib = ctypes.CDLL(str(so))
        for name, sig in mod._SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = sig, ctypes.c_int
        libs[src.stem] = lib
    x, dt, a, b, c, gy, Q = _inputs(dev)
    ref_y = mod.ssd_scan_plain(x, dt, a, b, c, chunk=Q)
    ref_g = mod.ssd_scan_backward_plain(x, dt, a, b, c, gy, chunk=Q)
    names = list(libs)
    for name in names + names[::-1]:
        mod._lib = lambda lib=libs[name]: lib
        f = cs.timed(lambda: mod.ssd_scan(x, dt, a, b, c, chunk=Q), dev, 20)
        bw = cs.timed(lambda: mod.ssd_scan_backward(x, dt, a, b, c, gy,
                                                    chunk=Q),
                      dev, 10, warmup=2)
        print(f"{name}: forward {f:.4f} ms, backward {bw:.4f} ms",
              flush=True)
    for name in names:
        mod._lib = lambda lib=libs[name]: lib
        y = mod.ssd_scan(x, dt, a, b, c, chunk=Q)
        g = mod.ssd_scan_backward(x, dt, a, b, c, gy, chunk=Q)
        errs = [cs.max_err(y, ref_y) / float(ref_y.abs().max())] + [
            cs.max_err(u, v) / float(v.abs().max()) for u, v in zip(g, ref_g)]
        print(f"{name}: max_abs_err / max|plain| y x dt a b c "
              + " ".join(f"{e:.2e}" for e in errs))
        print(f"{name}: ms a launch " + "; ".join(
            f"{k} {ms:.4f}" for ms, _, k in
            _per_pass(mod, x, dt, a, b, c, gy, Q)))
    smi()


def main(argv):
    if not argv:
        sys.exit(__doc__)
    mode, rest = argv[0], argv[1:]
    if mode == "measure":
        measure("--train" in rest)
    elif mode == "compare" and len(rest) == 1:
        compare(rest[0])
    elif mode == "passes":
        passes()
    elif mode == "unit":
        unit()
    elif mode == "ab" and rest:
        ab(rest)
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
