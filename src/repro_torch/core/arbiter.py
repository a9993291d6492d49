"""Multi-tenant arbitration (paper §4.4) behind one interface.

``Arbiter`` owns the per-tenant Fig. 3 hysteresis — violation jumps the
chosen victim straight to its most-approximate variant, then reclaims its
quanta one at a time; slack returns quanta before stepping variants back
toward precise, one move per decision interval — and delegates only WHICH
tenant moves to a victim policy:

* ``RoundRobinArbiter``        — the paper's baseline: cursor order, no app
  penalized disproportionately. Kept as the comparison baseline.
* ``InterferenceAwareArbiter`` — attributes the contended resource from the
  interactive service's sensitivity vector (HBM- vs ICI- vs compute-
  sensitive) weighted by the tenants' live roofline pressures, then picks
  the victim maximizing contended-pressure relieved per unit quality loss
  (PAPERS.md: interference-and-need-aware colocation; CuttleSys per-resource
  attribution). De-approximation runs the same ledger in reverse: quality is
  bought back where it adds the least contended pressure.

Budgets are PER TENANT (``budgets[i]``, defaulting to ``cfg.max_reclaim``):
heterogeneous tenants no longer share one budget sized from the first job.

Both arbiters actuate bound tenants directly (``tenant.set_variant`` /
``reclaim`` / ``return_quanta``) so the simulator and the real serve/train
runtimes share this exact code path — the only fork between them is where
the latency signal comes from.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.controller import Action, AppState, ControllerConfig
from repro_torch.core.variants import ResourcePressure

_EPS = 1e-9


@dataclass
class Arbiter:
    """Shared skeleton: Fig. 3 hysteresis over N tenants; subclasses supply
    the four victim-selection policies. ``tenants`` is optional — without it
    the arbiter is a pure decision state machine (the property tests drive
    it that way); with it every decision is actuated immediately."""
    n_variants_per_app: List[int]
    cfg: ControllerConfig = field(default_factory=ControllerConfig)
    tenants: Optional[Sequence] = None
    budgets: Optional[List[int]] = None
    states: List[AppState] = field(init=False)

    def __post_init__(self):
        self.states = [AppState(n) for n in self.n_variants_per_app]

    @classmethod
    def from_tenants(cls, tenants: Sequence, cfg: ControllerConfig, **kw):
        """Bind live tenants: variant counts and per-tenant reclaim budgets
        come from each tenant itself."""
        return cls([t.n_variants for t in tenants], cfg, tenants=tenants,
                   budgets=[t.max_reclaim for t in tenants], **kw)

    # --------------------------------------------------------- bookkeeping --

    def budget(self, i: int) -> int:
        return self.budgets[i] if self.budgets is not None \
            else self.cfg.max_reclaim

    def set_budget(self, i: int, b: int) -> None:
        if self.budgets is None:
            self.budgets = [self.cfg.max_reclaim] * len(self.states)
        self.budgets[i] = b

    def _jumpable(self) -> List[int]:
        return [i for i, s in enumerate(self.states)
                if s.variant < s.most_approx]

    def _reclaimable(self) -> List[int]:
        return [i for i, s in enumerate(self.states)
                if s.reclaimed < self.budget(i)]

    def _returnable(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s.reclaimed > 0]

    def _steppable(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s.variant > 0]

    # ----------------------------------------------------------- decisions --

    def tick(self, qos_violated: bool, slack: float, t: float = 0.0
             ) -> Tuple[Action, Optional[int]]:
        """One decision interval. Returns (action, victim index)."""
        if qos_violated:
            i = self.pick_jump(t)
            if i is not None:
                self.states[i].variant = self.states[i].most_approx
                self._apply_variant(i)
                return Action.SET_MOST_APPROX, i
            i = self.pick_reclaim(t)
            if i is not None:
                self.states[i].reclaimed += 1
                self._apply_reclaim(i, +1)
                return Action.RECLAIM_CHIPS, i
            return Action.HOLD, None
        if slack > self.cfg.slack_threshold:
            i = self.pick_return(t)
            if i is not None:
                self.states[i].reclaimed -= 1
                self._apply_reclaim(i, -1)
                return Action.RETURN_CHIPS, i
            i = self.pick_step_precise(t)
            if i is not None:
                self.states[i].variant -= 1
                self._apply_variant(i)
                return Action.STEP_PRECISE, i
        return Action.HOLD, None

    def _apply_variant(self, i: int) -> None:
        if self.tenants is not None:
            self.tenants[i].set_variant(self.states[i].variant)

    def _apply_reclaim(self, i: int, d: int) -> None:
        if self.tenants is not None:
            if d > 0:
                self.tenants[i].reclaim(1)
            else:
                self.tenants[i].return_quanta(1)

    # ----------------------------------------------------- victim policies --

    def pick_jump(self, t: float) -> Optional[int]:
        raise NotImplementedError

    def pick_reclaim(self, t: float) -> Optional[int]:
        raise NotImplementedError

    def pick_return(self, t: float) -> Optional[int]:
        raise NotImplementedError

    def pick_step_precise(self, t: float) -> Optional[int]:
        raise NotImplementedError


@dataclass
class RoundRobinArbiter(Arbiter):
    """Paper §4.4 baseline: approximate one app at a time in cursor order;
    only when ALL run most-approximate, reclaim quanta one app and one
    quantum at a time — no app penalized disproportionately."""
    start: int = 0                  # paper: first victim selected randomly
    _cursor: int = field(init=False)

    def __post_init__(self):
        super().__post_init__()
        self._cursor = self.start % len(self.states)

    def _next(self, candidates: List[int]) -> Optional[int]:
        n = len(self.states)
        cset = set(candidates)
        for d in range(n):
            i = (self._cursor + d) % n
            if i in cset:
                self._cursor = (i + 1) % n
                return i
        return None

    def pick_jump(self, t: float) -> Optional[int]:
        return self._next(self._jumpable())

    def pick_reclaim(self, t: float) -> Optional[int]:
        return self._next(self._reclaimable())

    def pick_return(self, t: float) -> Optional[int]:
        return self._next(self._returnable())

    def pick_step_precise(self, t: float) -> Optional[int]:
        return self._next(self._steppable())


@dataclass
class InterferenceAwareArbiter(Arbiter):
    """Resource-attributed victim selection, asymmetric like Fig. 3 itself:
    under violation, relieve the contended resource as fast as possible
    (jump the victim with the largest absolute relief; reclaim where each
    quantum sheds the most); under slack, buy quality back where it costs
    the least contended pressure (step-precise by quality gained per unit
    pressure added; return quanta where regrowth adds the least).

    ``sensitivity`` is the interactive service's per-resource sensitivity
    vector (``ServiceProfile.sensitivity``; reusing ``ResourcePressure`` as
    the vector type). Each decision first ATTRIBUTES the contended resource:
    the axis maximizing ``sensitivity_axis * sum_j pressure_j.axis`` — the
    resource the service both cares about and the tenants are saturating —
    then scores moves on that axis alone (CuttleSys-style per-resource
    attribution rather than a scalar interference blob).

    Requires bound tenants (their ``pressure(t, variant)`` supplies the
    roofline terms; ``n_quanta`` scales per-quantum relief)."""
    sensitivity: ResourcePressure = field(
        default_factory=lambda: ResourcePressure(hbm=0.6, ici=0.25,
                                                 flops=0.15))

    def __post_init__(self):
        super().__post_init__()
        assert self.tenants is not None, \
            "InterferenceAwareArbiter needs bound tenants for pressures"

    # ------------------------------------------------------- attribution --

    def contended_axis(self, t: float) -> str:
        """Attribute contention to one resource: sensitivity-weighted
        aggregate tenant pressure, highest axis wins."""
        agg = {"hbm": 0.0, "ici": 0.0, "flops": 0.0}
        for tn in self.tenants:
            p = tn.pressure(t)
            agg["hbm"] += p.hbm
            agg["ici"] += p.ici
            agg["flops"] += p.flops
        w = {"hbm": self.sensitivity.hbm * agg["hbm"],
             "ici": self.sensitivity.ici * agg["ici"],
             "flops": self.sensitivity.flops * agg["flops"]}
        return max(w, key=lambda a: (w[a], a))

    def _axis_pressure(self, i: int, t: float, axis: str,
                       variant: Optional[int] = None) -> float:
        return getattr(self.tenants[i].pressure(t, variant), axis)

    # --------------------------------------------------- victim policies --

    def pick_jump(self, t: float) -> Optional[int]:
        """Most ABSOLUTE contended pressure relieved by a jump to
        most-approximate. Under violation the scarce resource is time, not
        quality: any victim jumped now is stepped back during slack on the
        same ledger, so exiting violation in the fewest intervals wins —
        quality-normalizing this score (relief per unit loss) was measured
        to pick efficient-but-small reliefs that leave the service
        violating longer (benchmarks/multiapp.py round-robin comparison)."""
        cands = self._jumpable()
        if not cands:
            return None
        axis = self.contended_axis(t)

        def score(i):
            s = self.states[i]
            return (self._axis_pressure(i, t, axis, s.variant)
                    - self._axis_pressure(i, t, axis, s.most_approx))

        return max(cands, key=lambda i: (score(i), -i))

    def pick_reclaim(self, t: float) -> Optional[int]:
        """Most contended pressure relieved per reclaimed quantum (a tenant
        on n quanta sheds ~pressure/n per quantum); quality loss is zero for
        all candidates (reclaiming slows, it does not approximate)."""
        cands = self._reclaimable()
        if not cands:
            return None
        axis = self.contended_axis(t)
        return max(cands, key=lambda i: (
            self._axis_pressure(i, t, axis)
            / max(self.tenants[i].n_quanta, 1), -i))

    def pick_return(self, t: float) -> Optional[int]:
        """Return quanta where regrowth adds the LEAST contended pressure —
        the heaviest contender stays throttled longest."""
        cands = self._returnable()
        if not cands:
            return None
        axis = self.contended_axis(t)
        return min(cands, key=lambda i: (
            self._axis_pressure(i, t, axis)
            / max(self.tenants[i].n_quanta, 1), i))

    def pick_step_precise(self, t: float) -> Optional[int]:
        """Most quality recovered per unit contended pressure added by one
        step toward precise."""
        cands = self._steppable()
        if not cands:
            return None
        axis = self.contended_axis(t)

        def score(i):
            s = self.states[i]
            gain = (self.tenants[i].quality_loss(s.variant)
                    - self.tenants[i].quality_loss(s.variant - 1))
            added = (self._axis_pressure(i, t, axis, s.variant - 1)
                     - self._axis_pressure(i, t, axis, s.variant))
            return gain / max(added, _EPS)

        return max(cands, key=lambda i: (score(i), -i))
