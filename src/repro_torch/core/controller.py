"""Pliant runtime algorithm — faithful implementation of paper Fig. 3.

State per colocation: the active variant index (0 = precise) and the number
of reclaimed resource quanta. The controller is deliberately agnostic to
WHAT a quantum is — the actuator decides: chip-groups for elastic batch
jobs (``PliantRuntime.reshard_fn``), page-pool quanta (``pool_pages``) for
the paged serving cache (``serve.pages.PagePool.set_reclaimed``). Per
decision interval:

* QoS violated, not at most-approximate  -> jump to MOST approximate variant
* QoS violated, already most-approximate -> reclaim one chip-group
* QoS met, slack > threshold, chips reclaimed -> return one chip-group
* QoS met, slack > threshold, no chips out    -> step one variant toward precise
* QoS met, low slack                          -> hold

The "jump to most approximate on violation, step back gradually" asymmetry is
the paper's anti-ping-pong hysteresis; the slack threshold (default 10%)
controls agility (§4.3, Fig. 9 sensitivity). Multi-tenant victim selection
lives in ``core/arbiter.py`` (round-robin baseline + interference-aware),
sharing this same per-tenant hysteresis.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Action(enum.Enum):
    HOLD = "hold"
    SET_MOST_APPROX = "set_most_approx"
    STEP_PRECISE = "step_toward_precise"
    RECLAIM_CHIPS = "reclaim_chips"
    RETURN_CHIPS = "return_chips"


@dataclass
class ControllerConfig:
    slack_threshold: float = 0.10
    decision_interval_s: float = 1.0
    max_reclaim: int = 8            # reclaimable quanta (chip-groups / pages)
    history_limit: int = 2048       # decision-history ring size (PliantRuntime)


@dataclass
class AppState:
    n_variants: int
    variant: int = 0                # 0 = precise
    reclaimed: int = 0

    @property
    def most_approx(self) -> int:
        return self.n_variants - 1


@dataclass
class PliantController:
    """Single interactive service x single approximate application."""
    n_variants: int
    cfg: ControllerConfig = field(default_factory=ControllerConfig)
    state: AppState = field(init=False)

    def __post_init__(self):
        self.state = AppState(self.n_variants)

    def tick(self, qos_violated: bool, slack: float) -> Action:
        s = self.state
        if qos_violated:
            if s.variant < s.most_approx:
                # immediately jump to most approximate (Fig. 3)
                s.variant = s.most_approx
                return Action.SET_MOST_APPROX
            if s.reclaimed < self.cfg.max_reclaim:
                s.reclaimed += 1
                return Action.RECLAIM_CHIPS
            return Action.HOLD
        if slack > self.cfg.slack_threshold:
            if s.reclaimed > 0:
                s.reclaimed -= 1            # return chips before de-approximating
                return Action.RETURN_CHIPS
            if s.variant > 0:
                s.variant -= 1              # one step toward precise
                return Action.STEP_PRECISE
        return Action.HOLD


def headroom_burst(runtime, qos_guard: float) -> bool:
    """THE guard-band predicate: True when the attached runtime's monitor
    has a tail estimate comfortably inside the QoS target — p99 at most
    ``(1 - qos_guard) * target`` — i.e. there is measured headroom to spend
    on throughput. Both serving burst knobs consult it: the admission chunk
    budget (``ServeEngine._chunk_budget`` bursts prefill chunks) and the
    megastep width (``ServeEngine._megastep_budget`` fuses K decode steps
    per dispatch while admissions want interleaving). An abstaining monitor
    (below ``min_samples``) or no runtime at all is NO evidence of headroom
    — callers stay conservative."""
    if runtime is None:
        return False
    mon = runtime.monitor
    p99 = mon.p99()
    return (p99 is not None and mon.qos_target_s > 0
            and p99 <= (1.0 - qos_guard) * mon.qos_target_s)

