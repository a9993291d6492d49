#!/usr/bin/env python3
"""Compare variants of the port's ``flash_attention`` kernel on one card.

  python3 tools/flash_bench.py ab SOURCE.cu[@-DNAME=VALUE,...] ...
      Each variant of ``csrc/flash_attention.cu`` (a source, with optional
      ``-D`` defines after an ``@``) is built with the port's nvcc flags
      into ``build/flash_ab/`` and called through the wrapper's C entry
      point (``flash_attention.launch_args``) on the cases of
      ``chip_smoke.py`` that must take the "tc" design: phi4-mini's
      training cell (``cell-bf16``), the edge cases of ``phi4_flash_cases``
      and gemma2-27b's ``prefill_with_cache`` shapes. Every variant's
      output is held to ``flash_attention_plain`` with
      ``chip_smoke.BF16_ROW`` (a variant over it is marked FAIL); then each
      shape is timed in turns, v0 .. vn vn .. v0, and the mean of a
      variant's two turns is printed beside the bound. A variant may be a
      deliberately broken copy of the source, to show the cases catch it.

Prints the card's name and power limit. Needs CUDA; run it from the
repository's root. Exits with 1 if any variant failed a case.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

def _build_variants(specs, out_dir):
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, spec in enumerate(specs):
        src, _, defs = spec.partition("@")
        so = out_dir / f"libv{i}.so"
        cmd = [_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}",
               *[d for d in defs.split(",") if d], "-o", str(so), src]
        procs.append((spec, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = []
    for spec, so, p in procs:
        out, err = p.communicate()
        if p.returncode:
            sys.exit(f"nvcc failed on {spec}:\n{out}{err}")
        for line in (out + err).splitlines():
            if "C75" in line:
                print(f"v{len(libs)} ptxas: {line.strip()[:160]}")
        libs.append(ctypes.CDLL(str(so)))
    return libs


def ab(specs):
    import torch
    sys.path[:0] = ["src", "."]
    if not torch.cuda.is_available():
        sys.exit("flash_bench: CUDA is not available")
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = _build_variants(specs, pathlib.Path("build/flash_ab"))
    for lib in libs:
        lib.flash_attention.argtypes = fa._ARGTYPES
        lib.flash_attention.restype = ctypes.c_int
    for i, spec in enumerate(specs):
        print(f"v{i}: {spec}")
    device = torch.device("cuda", 0)
    cases = [c for c in cs.phi4_flash_cases() + cs.gemma2_flash_cases()
             if c.get("design") == "tc"]
    failed = set()
    for c in cases:
        B, H, KVH, Sq, Skv, hd = c["shape"]
        bq, bk = c.get("grid", (128, 128))
        kw = dict(causal=c.get("causal", True), window=c.get("window", 0),
                  cap=c.get("cap", 0.0), kv_keep_stride=c.get("stride", 1))
        q, k, v = cs.flash_case(B, H, KVH, Sq, Skv, hd, torch.bfloat16,
                                device, q_scale=c.get("q_scale", 1.0))
        ref = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)

        def call(lib):
            out = torch.empty_like(q)
            args, _ = fa.launch_args(q, k, v, out, kw["causal"],
                                     kw["window"], kw["cap"],
                                     kw["kv_keep_stride"], bq, bk)
            rc = lib.flash_attention(*args)
            if rc:
                raise RuntimeError(f"launch failed, cudaError {rc}")
            return out
        excess = []
        for lib in libs:
            out = call(lib)
            torch.cuda.synchronize()
            excess.append(cs.bf16_row_excess(out, ref))
        order = list(range(len(libs))) + list(reversed(range(len(libs))))
        ms = [0.0] * len(libs)
        for i in order:
            ms[i] += cs.timed(lambda: call(libs[i]), device, 10) / 2
        pairs = cs.flash_kept_pairs(Sq, Skv, kw, device, (bq, bk))
        bound, _ = cs.flash_bound_ms(B, H, KVH, Sq, Skv, hd, 2, pairs)
        print(f"{c['name']}: " + " ".join(
            f"v{i} {t:.4f} ms (excess {e:.3g}"
            + (")" if e <= cs.BF16_ROW else " FAIL)")
            for i, (t, e) in enumerate(zip(ms, excess)))
            + f"; bound {bound:.4f} ms", flush=True)
        failed |= {i for i, e in enumerate(excess) if not e <= cs.BF16_ROW}
        del q, k, v, ref
        torch.cuda.empty_cache()
    print(f"tolerance {cs.BF16_ROW:.3g} row rms: " + " ".join(
        f"v{i} {'FAIL' if i in failed else 'pass'}"
        for i in range(len(libs))))
    if failed:
        sys.exit(1)


def main(argv):
    if len(argv) < 2 or argv[0] != "ab":
        sys.exit(__doc__)
    ab(argv[1:])


if __name__ == "__main__":
    main(sys.argv[1:])
