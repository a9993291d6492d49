"""Build the port's CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``build/torch_kernels/<hash>/`` at the repository root, where the hash
covers the source, every header ``csrc/*.cuh`` (which a source may include)
and the flags: an edited source or header rebuilds, an unchanged one
loads. The first use builds every source at once, one ``nvcc`` process per
file, all started together. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Set, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("flash_attention", "flash_tc", "int8_matmul", "paged_attention",
           "quantize_rows", "ring_hop", "ssd_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_TYPED: Set[Tuple[str, str]] = set()   # (library, entry) given argtypes
ptxas_log: Dict[str, str] = {}       # nvcc's -Xptxas -v report per source
build_seconds: Dict[str, float] = {}  # each source's nvcc wall seconds


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels build only where the CUDA toolkit is")


def _so_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / h.hexdigest()[:16] / f"lib{name}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel. Returns
    the wall seconds spent (0 when everything was already built); each
    source's own seconds go to ``build_seconds``."""
    t0 = time.perf_counter()
    todo = [(n, _so_path(n)) for n in SOURCES if not _so_path(n).exists()]
    procs = []
    nvcc = _nvcc() if todo else None
    for name, so in todo:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))

    def wait(p):
        out = p.communicate()
        return out, time.perf_counter() - t0
    with ThreadPoolExecutor(max(1, len(procs))) as pool:
        done = list(pool.map(wait, [p for *_, p in procs]))
    failed = []
    for (name, so, tmp, p), ((out, err), secs) in zip(procs, done):
        ptxas_log[name] = out + err
        build_seconds[name] = secs
        if p.returncode:
            failed.append(f"nvcc failed on {name}.cu:\n{out}{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, argtypes, entry: str = "") -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all on first use),
    with its C entry point ``entry`` (default ``name``) typed by
    ``argtypes`` (returns the launch's ``cudaGetLastError()`` as an int)."""
    lib = _LIBS.get(name)
    if lib is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {name}: CUDA is not available")
        build_all()
        lib = ctypes.CDLL(str(_so_path(name)))
        _LIBS[name] = lib
    if (name, entry) not in _TYPED:
        fn = getattr(lib, entry or name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _TYPED.add((name, entry))
    return lib
