"""Variant table: the AOT-compiled executable registry (paper §4.2).

Pliant compiles every approximate variant of every approximable function into
ONE binary and swaps function pointers on a Linux signal via DynamoRIO. The
XLA analogue: every variant of ``train_step``/``serve_step`` is jitted and
compiled ONCE up front against the same param pytree; the actuator switches
which executable runs at the next step boundary — an O(µs) dictionary lookup,
no recompilation on the critical path.

Variants are ordered precise-first, increasingly approximate — the order the
Fig-3 controller walks.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.approx.knobs import ApproxKnobs, PRECISE


@dataclass(frozen=True)
class ResourcePressure:
    """Fractions of step time each shared resource is saturated (from the
    dry-run roofline terms: term / bound). Drives the colocation model."""
    hbm: float = 0.8
    ici: float = 0.2
    flops: float = 0.5

    def scaled(self, f: float) -> "ResourcePressure":
        return ResourcePressure(self.hbm * f, self.ici * f, self.flops * f)


@dataclass(frozen=True)
class Variant:
    knobs: ApproxKnobs
    rel_time: float              # step time relative to precise execution
    quality_loss: float          # 0..1 output-quality loss vs precise
    pressure: ResourcePressure = ResourcePressure()

    @property
    def name(self) -> str:
        return self.knobs.describe()


@dataclass
class VariantTable:
    """Ordered: index 0 = precise, last = most approximate."""
    variants: List[Variant]
    executables: Dict[int, Any] = field(default_factory=dict)
    compile_times: Dict[int, float] = field(default_factory=dict)

    def __post_init__(self):
        assert self.variants and self.variants[0].knobs.is_precise(), \
            "variant 0 must be precise execution"

    def __len__(self) -> int:
        return len(self.variants)

    @property
    def most_approximate(self) -> int:
        return len(self.variants) - 1

    def compile_all(self, factory: Callable[[ApproxKnobs], Any],
                    lower: Optional[Callable[[Any], Any]] = None) -> None:
        """factory(knobs) -> step fn; optional lower(step) -> compiled.

        This is the offline 'single binary with all variants' build step.
        """
        for i, v in enumerate(self.variants):
            t0 = time.time()
            step = factory(v.knobs)
            self.executables[i] = lower(step) if lower is not None else step
            self.compile_times[i] = time.time() - t0

    def executable(self, idx: int) -> Any:
        return self.executables[idx]

    def overhead_fraction(self, run_time_s: float) -> float:
        """Instrumentation overhead analogue (DynamoRIO cost in the paper)."""
        return sum(self.compile_times.values()) / max(run_time_s, 1e-9)
