"""Tenant protocol: one co-scheduled approximate application under the
multi-tenant Pliant control plane.

The arbiter (``core/arbiter.py``) is deliberately agnostic to WHAT a tenant
is — a batch training job yielding chip-groups, a paged serving engine
yielding pool pages, or a queueing-model job inside the colocation
simulator. Every tenant exposes the same small surface:

* ``n_variants`` / ``set_variant(i)`` — the AOT-compiled approximation
  ladder (index 0 = precise) and the actuator that hot-swaps it at the next
  step boundary.
* ``reclaim(k)`` / ``return_quanta(k)`` — shrink/regrow the tenant's share
  of the contended resource in quanta (chip-groups, pool pages). Each
  tenant carries its OWN budget (``max_reclaim``) — heterogeneous tenants
  no longer share one budget sized from the first job.
* ``pressure(t, variant)`` — the per-resource ``ResourcePressure`` the
  tenant exerts on the shared substrate, sourced from the explorer's
  compiled-cell ``cost_analysis`` roofline terms per variant (that is what
  ``VariantTable`` pressures are), scaled by whatever share of the resource
  the tenant currently holds. This is what lets the interference-aware
  arbiter attribute contention and pick the victim that relieves the most
  of it per unit quality loss.

Concrete adapters:

* ``TrainTenant``   — elastic train job: executable swap via the table,
  chip-group reshard via ``reshard_fn(reclaimed)``.
* ``ServeTenant``   — paged ``ServeEngine``: deferred-safe variant hot-swap
  (``engine.request_variant``), ``PagePool`` quanta via ``set_reclaimed``;
  HBM pressure scales with live-page occupancy.
* ``SimTenant``     — a ``core.colocation.BatchJob`` inside the simulator;
  state lives on the job.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.core.variants import ResourcePressure, VariantTable


class Tenant:
    """Protocol + shared bookkeeping for one arbitrated application.

    Subclasses implement ``_on_variant``/``_on_reclaimed`` actuation hooks
    (and may override ``pressure`` for tenant-specific scaling). State is
    kept here so the arbiter can read it back uniformly."""

    name: str = "tenant"
    table: Optional[VariantTable] = None
    max_reclaim: int = 0          # per-tenant reclaimable-quanta budget
    n_quanta: int = 1             # total quanta backing the tenant (relief
    _variant: int = 0             # per reclaimed quantum ~ pressure/n_quanta)
    _reclaimed: int = 0
    reshard_fn: Optional[Callable[[int], None]] = None   # late-bound quanta
    # actuator (``rebind``): receives the ABSOLUTE reclaimed count, and is
    # honored by EVERY adapter's ``_on_reclaimed`` chain — a runtime's
    # ``attach_reclaimer`` must never silently no-op on a bound tenant

    # ------------------------------------------------------------ variants --

    @property
    def n_variants(self) -> int:
        return len(self.table) if self.table is not None else 1

    @property
    def variant(self) -> int:
        return self._variant

    def set_variant(self, idx: int) -> None:
        assert 0 <= idx < self.n_variants, (idx, self.n_variants)
        self._variant = idx
        self._on_variant(idx)

    def quality_loss(self, variant: Optional[int] = None) -> float:
        v = self.variant if variant is None else variant
        return self.table.variants[v].quality_loss if self.table else 0.0

    # -------------------------------------------------------------- quanta --

    @property
    def reclaimed(self) -> int:
        return self._reclaimed

    def reclaim(self, k: int = 1) -> None:
        self._reclaimed = min(self._reclaimed + k, self.max_reclaim)
        self._on_reclaimed(self._reclaimed)

    def return_quanta(self, k: int = 1) -> None:
        self._reclaimed = max(self._reclaimed - k, 0)
        self._on_reclaimed(self._reclaimed)

    # ------------------------------------------------------------ pressure --

    def share(self) -> float:
        """Fraction of the tenant's nominal resource share still held."""
        return max(self.n_quanta - self.reclaimed, 0) / max(self.n_quanta, 1)

    def pressure(self, t: float = 0.0,
                 variant: Optional[int] = None) -> ResourcePressure:
        """Pressure the tenant exerts NOW (or would exert at ``variant``):
        the explorer's roofline terms for that variant, scaled by the share
        of the resource the tenant currently holds."""
        v = self.variant if variant is None else variant
        base = self.table.variants[v].pressure if self.table \
            else ResourcePressure()
        return base.scaled(self.share())

    # ----------------------------------------------------- actuation hooks --

    def rebind(self, fn: Callable[[int], None],
               max_reclaim: Optional[int] = None) -> None:
        """Late-bind the quanta actuator (construction order often puts the
        actuator after the runtime) and optionally restore the budget."""
        self.reshard_fn = fn
        if max_reclaim is not None:
            self.max_reclaim = max_reclaim
            self.n_quanta = max(self.n_quanta, max_reclaim + 1)

    def _on_variant(self, idx: int) -> None:
        pass

    def _on_reclaimed(self, total: int) -> None:
        if self.reshard_fn is not None:
            self.reshard_fn(total)

    # ------------------------------------------------------------ capacity --

    def on_capacity(self, ev) -> None:
        """Receive a ``dist.elastic.CapacityEvent`` fanned out by
        ``PliantRuntime.inject`` (which has ALREADY recorded it as
        contention pressure). Adapters with an elastic substrate actuate:
        the serve adapter re-homes its engine, the train adapter reshards
        its params/optimizer mid-flight. The base tenant has nothing to
        shrink — pressure alone (variant ladder via the arbiter) is its
        whole response."""


@dataclass
class TrainTenant(Tenant):
    """Elastic batch-training job: the table's jitted step executables are
    hot-swapped by index (``runtime.step_executable``); ``reshard_fn`` — when
    the job is elastic — receives the ABSOLUTE reclaimed chip-group count
    (the PR-1 ``dist`` reshard/restore path, or a scheduler callback)."""
    table: VariantTable = None
    name: str = "train"
    reshard_fn: Optional[Callable[[int], None]] = None
    max_reclaim: int = 0
    n_quanta: int = 1
    # live-shrink actuator: receives each CapacityEvent fanned out by
    # ``PliantRuntime.inject``; the launch/train chaos path binds it to the
    # mid-flight ``dist.elastic.reshard_live`` of (params, optimizer state)
    # on the surviving mesh + a variant-table recompile
    elastic_fn: Optional[Callable[[Any], None]] = None
    _variant: int = field(default=0, init=False)
    _reclaimed: int = field(default=0, init=False)

    def __post_init__(self):
        if self.reshard_fn is None:
            # no actuator for quanta reclamation: a non-zero budget would
            # burn decision intervals on phantom RECLAIM/RETURN actions
            # before the arbiter steps the tenant back toward precise
            self.max_reclaim = 0
        self.n_quanta = max(self.n_quanta, self.max_reclaim + 1)

    def on_capacity(self, ev) -> None:
        if self.elastic_fn is not None:
            self.elastic_fn(ev)


@dataclass
class ServeTenant(Tenant):
    """Paged ``ServeEngine`` adapter. Variant swaps go through
    ``engine.request_variant`` (applied at the next SAFE step boundary — a
    mid-admission swap would mix prefill executables within one request);
    quanta are ``PagePool`` pages via ``set_reclaimed``. Dense engines have
    no reclaimable pool, so their budget is 0 (variant knob only)."""
    engine: Any = None
    name: str = "serve"
    table: VariantTable = field(init=False)
    max_reclaim: int = field(init=False)
    n_quanta: int = field(init=False)
    _variant: int = field(default=0, init=False)
    _reclaimed: int = field(default=0, init=False)

    def __post_init__(self):
        self.table = self.engine.table
        pool = getattr(self.engine, "pool", None)
        self.max_reclaim = pool.max_quanta if pool is not None else 0
        self.n_quanta = (max(pool.spec.usable // max(pool.quantum, 1), 1)
                         if pool is not None else 1)
        self._variant = self.engine.active_variant

    @property
    def variant(self) -> int:
        # decision-state view: the engine may still be deferring the swap
        return self._variant

    def _on_variant(self, idx: int) -> None:
        self.engine.request_variant(idx)

    def _on_reclaimed(self, total: int) -> None:
        if self.engine.pool is not None:
            self.engine.pool.set_reclaimed(total)
        super()._on_reclaimed(total)     # honor a late-bound actuator too

    # on_capacity stays the base no-op: the port's engine serves one device
    # and has no elastic re-home, so a capacity event acts as pressure only

    def pressure(self, t: float = 0.0,
                 variant: Optional[int] = None) -> ResourcePressure:
        """Roofline pressure of the (target) serving variant; for paged
        engines the HBM term scales with live-page occupancy — the fused
        decode kernel streams mapped pages, not ``slots x max_len`` rings
        (DESIGN.md §10), so a half-empty pool exerts half the KV traffic."""
        v = self.variant if variant is None else variant
        p = self.table.variants[v].pressure
        pool = self.engine.pool
        if pool is not None:
            p = ResourcePressure(hbm=p.hbm * max(pool.occupancy(), 0.05),
                                 ici=p.ici, flops=p.flops)
        return p


@dataclass
class SimTenant(Tenant):
    """Colocation-simulator adapter: variant/reclaimed state lives ON the
    ``BatchJob`` so ``advance``/``interference_of``/timeline reads see every
    actuation without mirroring."""
    job: Any = None
    name: str = field(init=False)
    table: VariantTable = field(init=False)
    max_reclaim: int = field(init=False)
    n_quanta: int = field(init=False)

    def __post_init__(self):
        self.name = self.job.name
        self.table = self.job.table
        # per-tenant budget from the tenant's OWN chip-groups — NOT from
        # jobs[0]: heterogeneous jobs used to get a wrong shared budget
        self.max_reclaim = self.job.chip_groups - 1
        self.n_quanta = self.job.chip_groups

    @property
    def variant(self) -> int:
        return self.job.variant

    @property
    def reclaimed(self) -> int:
        return self.job.reclaimed

    def set_variant(self, idx: int) -> None:
        assert 0 <= idx < self.n_variants, (idx, self.n_variants)
        self.job.variant = idx

    def reclaim(self, k: int = 1) -> None:
        self.job.reclaimed = min(self.job.reclaimed + k, self.max_reclaim)

    def return_quanta(self, k: int = 1) -> None:
        self.job.reclaimed = max(self.job.reclaimed - k, 0)

    def pressure(self, t: float = 0.0,
                 variant: Optional[int] = None) -> ResourcePressure:
        """The variant's ROOFLINE pressure scaled by the chip share still
        held — deliberately NOT the job's instantaneous phase-modulated
        pressure. The arbiter sees what a deployed controller would know:
        the explorer's compiled-cell profile per variant. Scoring on the
        live phase was measured WORSE (benchmarks/multiapp.py): a victim
        picked at its phase trough looks cheap, then its phase swings up —
        the phase-free profile hedges across phases the way round-robin
        hedges across apps, while still ranking tenants by what they
        structurally exert on each resource."""
        v = self.job.variant if variant is None else variant
        return self.job.table.variants[v].pressure.scaled(
            self.job.chip_frac())
