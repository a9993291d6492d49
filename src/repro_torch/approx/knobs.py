"""ApproxKnobs: the approximation design space (paper §3).

A copy of the JAX package's ``approx/knobs.py``. Each field is one knob; an
*approximate variant* is a concrete knob setting. The serving ladder uses
two of them: ``matmul_precision`` (bf16 -> int8 W8A8 MLP matmuls) and
``kv_quant`` (int8 KV cache).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class ApproxKnobs:
    matmul_precision: str = "bf16"   # "bf16" | "int8"
    token_drop: float = 0.0          # 0 .. <1: fraction of batch perforated
    layer_skip: float = 0.0          # 0 .. <1: fraction of layer groups skipped
    kv_keep_stride: int = 1          # 1 = precise; p>1 keeps 1/p old KV blocks
    topk_override: int = 0           # 0 = model default
    sync_period: int = 1             # 1 = precise sync every step
    grad_compress: str = "none"      # "none" | "int8"
    kv_quant: bool = False

    def is_precise(self) -> bool:
        return self == PRECISE

    def describe(self) -> str:
        parts = []
        if self.matmul_precision != "bf16":
            parts.append(self.matmul_precision)
        if self.token_drop:
            parts.append(f"drop{self.token_drop:.0%}")
        if self.layer_skip:
            parts.append(f"skip{self.layer_skip:.0%}")
        if self.kv_keep_stride > 1:
            parts.append(f"kvstride{self.kv_keep_stride}")
        if self.topk_override:
            parts.append(f"topk{self.topk_override}")
        if self.sync_period > 1:
            parts.append(f"sync/{self.sync_period}")
        if self.grad_compress != "none":
            parts.append(f"g{self.grad_compress}")
        if self.kv_quant:
            parts.append("kvq8")
        return "+".join(parts) or "precise"


PRECISE = ApproxKnobs()


def keep_groups(n_groups: int, layer_skip: float) -> tuple:
    """Static strided subset of layer groups for the layer-skip knob (always
    keeps the first and last group)."""
    if layer_skip <= 0:
        return tuple(range(n_groups))
    n_keep = max(2, round(n_groups * (1.0 - layer_skip)))
    if n_keep >= n_groups:
        return tuple(range(n_groups))
    import numpy as np
    idx = np.linspace(0, n_groups - 1, n_keep).round().astype(int)
    return tuple(sorted(set(int(i) for i in idx)))
