"""PliantRuntime: monitor -> arbiter -> tenant glue for REAL runs.

A thin shell over an ``Arbiter`` and a tenant list: every decision interval
(wall-clock deadline — a straggling step cannot delay control decisions, the
runtime simply acts at the next boundary) it consumes the monitor's window
and lets the arbiter pick and actuate one victim move. All actuation goes
through the ``Tenant`` protocol (``core/tenant.py``): executable hot-swap,
chip-group reshard, page-pool reclaim — the runtime no longer special-cases
any of them.

Backward-compatible single-tenant construction: ``PliantRuntime(table,
monitor, cfg, reshard_fn=...)`` wraps the table in a ``TrainTenant`` (budget
0 without a reshard actuator, so the controller never burns intervals on
phantom RECLAIM/RETURN actions) under a single-tenant round-robin arbiter —
which is exactly the Fig. 3 ``PliantController`` policy. Multi-tenant:
``PliantRuntime(monitor=m, cfg=c, tenants=[...], arbiter=...)``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional

from repro_torch.core.arbiter import Arbiter, RoundRobinArbiter
from repro_torch.core.controller import Action, ControllerConfig
from repro_torch.core.monitor import LatencyMonitor
from repro_torch.core.tenant import Tenant, TrainTenant
from repro_torch.core.variants import VariantTable
from repro_torch.dist.elastic import PRESSURE_OFF, PRESSURE_ON


@dataclass
class PliantRuntime:
    table: Optional[VariantTable] = None
    monitor: LatencyMonitor = None
    cfg: ControllerConfig = field(default_factory=ControllerConfig)
    reshard_fn: Optional[Callable[[int], None]] = None   # reclaimed groups
    tenants: Optional[List[Tenant]] = None
    arbiter: Optional[Arbiter] = None
    _last_decision: float = field(init=False)
    _auto_tenant: bool = field(init=False, default=False)
    history: Deque[dict] = field(init=False)

    def __post_init__(self):
        if self.tenants is None:
            assert self.table is not None, \
                "PliantRuntime needs a table (single-tenant) or tenants"
            budget = self.cfg.max_reclaim if self.reshard_fn is not None \
                else 0
            self.tenants = [TrainTenant(self.table, reshard_fn=self.reshard_fn,
                                        max_reclaim=budget)]
            self._auto_tenant = True
            self._sync_cfg_budget()
        elif self.table is None:
            self.table = self.tenants[0].table
        if self.arbiter is None:
            self.arbiter = RoundRobinArbiter.from_tenants(self.tenants,
                                                          self.cfg)
        self.history = collections.deque(maxlen=self.cfg.history_limit)
        self._last_decision = time.monotonic()
        self._capacity_out = 0      # outstanding PRESSURE_ON capacity events
        self.capacity_log: List[dict] = []

    def _sync_cfg_budget(self) -> None:
        """Single-tenant compat: ``cfg.max_reclaim`` mirrors the tenant's
        own budget (callers/tests read it as THE reclaim budget)."""
        if len(self.tenants) == 1 \
                and self.tenants[0].max_reclaim != self.cfg.max_reclaim:
            self.cfg = dataclasses.replace(
                self.cfg, max_reclaim=self.tenants[0].max_reclaim)
            if self.arbiter is not None:
                self.arbiter.cfg = self.cfg

    # ------------------------------------------------------------- binding --

    def bind(self, tenant: Tenant, index: int = 0) -> None:
        """Replace a tenant (the auto-built placeholder, usually) with a
        real adapter — e.g. the serve engine binding itself at construction.
        Rebuilds the arbiter, so it is construction-time only: after any
        decision the arbiter's variant/reclaimed ledger and the tenants'
        actuated state would silently diverge (reclaimed quanta never
        returned)."""
        from repro_torch.core.arbiter import InterferenceAwareArbiter
        assert not self.history, \
            "bind() after decisions would discard the arbiter ledger"
        self.tenants[index] = tenant
        kw = {}
        if isinstance(self.arbiter, RoundRobinArbiter):
            kw["start"] = self.arbiter.start
        if isinstance(self.arbiter, InterferenceAwareArbiter):
            kw["sensitivity"] = self.arbiter.sensitivity
        self.arbiter = type(self.arbiter).from_tenants(self.tenants,
                                                       self.cfg, **kw)
        self._auto_tenant = False
        if index == 0 and tenant.table is not None:
            self.table = tenant.table
        self._sync_cfg_budget()

    @property
    def auto_tenant(self) -> bool:
        """True while tenant 0 is the constructor's placeholder wrap."""
        return self._auto_tenant

    def attach_reclaimer(self, fn: Callable[[int], None],
                         max_reclaim: Optional[int] = None) -> None:
        """Late-bind a reclaim actuator on tenant 0 and restore its budget
        (construction order often puts the actuator after the runtime).
        ``fn(k)`` receives the ABSOLUTE reclaimed-quanta count on every
        RECLAIM/RETURN, whatever adapter tenant 0 is (a bound ServeTenant
        chains it after its own pool actuation)."""
        self.reshard_fn = fn
        self.tenants[0].rebind(fn, max_reclaim)
        if max_reclaim is not None:
            self.arbiter.set_budget(0, self.tenants[0].max_reclaim)
            self._sync_cfg_budget()

    # --------------------------------------------------------------- state --

    @property
    def active_variant(self) -> int:
        return self.arbiter.states[0].variant

    @property
    def reclaimed(self) -> int:
        return self.arbiter.states[0].reclaimed

    def step_executable(self) -> Any:
        return self.table.executable(self.active_variant)

    # ------------------------------------------------------------ capacity --

    def notify_capacity(self, ev) -> None:
        """A ``dist.elastic.CapacityEvent`` is a CONTENTION SOURCE: while
        any revocation or quota cut is outstanding, every decision tick sees
        the violation arm of the Fig. 3 hysteresis — the arbiter
        de-approximates / reclaims from victims exactly as it does under QoS
        pressure, and a restore lets the slack arm walk tenants back toward
        precise. The arbiter itself is unchanged; deflation simply enters
        the loop through the same gate as a p99 violation."""
        if ev.kind in PRESSURE_ON:
            self._capacity_out += 1
        elif ev.kind in PRESSURE_OFF:
            self._capacity_out = max(self._capacity_out - 1, 0)
        self.capacity_log.append(dict(t=time.monotonic(), kind=ev.kind,
                                      outstanding=self._capacity_out))

    @property
    def capacity_pressure(self) -> bool:
        return self._capacity_out > 0

    def inject(self, ev) -> None:
        """Fleet-level fault entry point (colocate/train drivers): record
        the event as contention pressure here, then fan it out to every
        tenant's ``on_capacity`` actuator (the serve adapter re-homes its
        engine, the train adapter reshards mid-flight)."""
        self.notify_capacity(ev)
        for t in self.tenants:
            t.on_capacity(ev)

    # ----------------------------------------------------------- decisions --

    def maybe_decide(self, now: Optional[float] = None) -> Optional[Action]:
        """Deadline-based decision tick; call once per batch step boundary."""
        now = time.monotonic() if now is None else now
        if now - self._last_decision < self.cfg.decision_interval_s:
            return None
        self._last_decision = now
        # one reset-window convention for every control plane (sim included):
        # read the closing window, act on it, start the next one fresh
        _, violated, slack = self.monitor.consume_window()
        if self.capacity_pressure:
            # outstanding capacity loss: force the violation arm (and mask
            # any slack reading — returning quanta while deflated would
            # fight the revocation)
            violated, slack = True, False
        action, victim = self.arbiter.tick(violated, slack, t=now)
        self.history.append({
            "t": now, "action": action.value, "victim": victim,
            "variant": self.active_variant, "reclaimed": self.reclaimed,
            "variants": tuple(s.variant for s in self.arbiter.states),
            "reclaimed_all": tuple(s.reclaimed
                                   for s in self.arbiter.states),
            "violated": violated, "slack": slack,
            "capacity": self._capacity_out})
        return action
