#!/usr/bin/env python3
"""Compare variants of the port's ``flash_attention`` kernel on one card.

  python3 tools/flash_bench.py ab [--only=SUBSTR,...] \
          SOURCE.cu[@-DNAME=VALUE,...][#simple] ...
      Each variant (a source, with optional ``-D`` defines after an
      ``@``) is built with the port's nvcc flags into ``build/flash_ab/``
      and called through the wrapper's C entry point
      (``flash_attention.launch_args``): ``flash_attention_tc`` for a "tc"
      case where the source has it (``csrc/flash_tc.cu``), else
      ``flash_attention`` (``csrc/flash_attention.cu``, or an older source
      that held every design), on the cases of
      ``chip_smoke.py`` that must take the "tc" or the "tiled" design
      (those whose name holds one of ``--only``'s strings, if given):
      phi4-mini's training cell, the edge cases of ``phi4_flash_cases``,
      gemma2-27b's and gemma3-12b's ``prefill_with_cache`` shapes,
      zamba2-2.7b's handoff (hd 80) and paligemma-3b's MQA (hd 256). A
      variant ending in ``#simple`` launches the "simple" design instead.
      Every variant's output is held to ``flash_attention_plain`` with
      ``chip_smoke.BF16_ROW`` in bf16 and ``FP32_ATOL`` in fp32 (a variant
      over it is marked FAIL; one whose launch is refused, as an older
      source refuses a head size it has no design for, is marked
      refused and not timed); then each shape is timed in turns, v0 .. vn
      vn .. v0, and the mean of a variant's two turns is printed beside
      the bound. A variant may be a deliberately broken copy of the
      source, to show the cases catch it.

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
        src, _, defs = spec.split("#")[0].partition("@")
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


def ab(specs, only=()):
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
    entries = []
    for lib in libs:
        entries.append({})
        for name in ("flash_attention", "flash_attention_tc"):
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = fa._ARGTYPES
                fn.restype = ctypes.c_int
                entries[-1][name] = fn
    for i, spec in enumerate(specs):
        print(f"v{i}: {spec}")
    device = torch.device("cuda", 0)
    simple = [spec.endswith("#simple") for spec in specs]
    cases = [c for c in cs.phi4_flash_cases() + cs.gemma2_flash_cases()
             + cs.gemma3_flash_cases() + cs.zamba2_flash_cases()
             + cs.encdec_flash_cases()
             if c.get("design", fa.select_flash_design(c["dtype"],
                                                       c["shape"][-1]))
             in ("tc", "tiled")
             and (not only or any(o in c["name"] for o in only))]
    failed = set()
    for c in cases:
        B, H, KVH, Sq, Skv, hd = c["shape"]
        bq, bk = c.get("grid", (128, 128))
        kw = dict(causal=c.get("causal", True), window=c.get("window", 0),
                  cap=c.get("cap", 0.0), kv_keep_stride=c.get("stride", 1))
        q, k, v = cs.flash_case(B, H, KVH, Sq, Skv, hd, c["dtype"],
                                device, q_scale=c.get("q_scale", 1.0))
        ref = fa.flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
        fp32 = c["dtype"] == torch.float32

        def call(i):
            out = torch.empty_like(q)
            args, design = fa.launch_args(q, k, v, out, kw["causal"],
                                          kw["window"], kw["cap"],
                                          kw["kv_keep_stride"], bq, bk)
            if simple[i]:
                args = args[:-2] + (fa._DESIGNS["simple"], args[-1])
            fns = entries[i]
            fn = fns.get("flash_attention_tc") if design == "tc" \
                and not simple[i] else None
            fn = fn or fns.get("flash_attention")
            if fn is None:
                raise RuntimeError("no entry point for the case")
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"launch failed, cudaError {rc}")
            return out
        excess, ran = [], []
        for i in range(len(libs)):
            try:
                out = call(i)
            except RuntimeError:
                excess.append(None)
                continue
            torch.cuda.synchronize()
            excess.append(cs.max_err(out, ref) if fp32
                          else cs.bf16_row_excess(out, ref))
            ran.append(i)
        tol = cs.FP32_ATOL if fp32 else cs.BF16_ROW
        order = ran + ran[::-1]
        ms = [0.0] * len(libs)
        for i in order:
            ms[i] += cs.timed(lambda: call(i), device, 10) / 2
        pairs = cs.flash_kept_pairs(Sq, Skv, kw, device, (bq, bk))
        bound, _ = cs.flash_bound_ms(B, H, KVH, Sq, Skv, hd,
                                     q.element_size(), pairs)
        print(f"{c['name']}: " + " ".join(
            f"v{i} refused" if e is None else
            f"v{i} {t:.4f} ms ({'err' if fp32 else 'excess'} {e:.3g}"
            + (")" if e <= tol else " FAIL)")
            for i, (t, e) in enumerate(zip(ms, excess)))
            + f"; bound {bound:.4f} ms", flush=True)
        failed |= {i for i, e in enumerate(excess)
                   if e is not None and not e <= tol}
        del q, k, v, ref
        torch.cuda.empty_cache()
    print(f"tolerance {cs.BF16_ROW:.3g} row rms (bf16), {cs.FP32_ATOL:.3g} "
          f"(fp32): " + " ".join(
        f"v{i} {'FAIL' if i in failed else 'pass'}"
        for i in range(len(libs))))
    if failed:
        sys.exit(1)


def main(argv):
    if len(argv) < 2 or argv[0] != "ab":
        sys.exit(__doc__)
    only = [a for a in argv[1:] if a.startswith("--only=")]
    ab([a for a in argv[1:] if not a.startswith("--only=")],
       tuple(o for a in only for o in a[len("--only="):].split(",") if o))


if __name__ == "__main__":
    main(sys.argv[1:])
