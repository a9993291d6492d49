"""Lightweight QoS performance monitor (paper §4.1).

Client-side end-to-end latency sampler with an *adaptive sampling rate*: when
observed tail latency approaches the QoS target, the sample rate rises toward
1.0; far from the boundary it decays, keeping overhead negligible — mirroring
the paper's "adaptive sampling of end-to-end latency".
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Optional

import numpy as np


@dataclass
class LatencyMonitor:
    qos_target_s: float
    window: int = 4096
    min_rate: float = 0.05
    min_samples: int = 20           # below this the tail estimate abstains
    _buf: Deque[float] = field(default_factory=lambda: collections.deque())
    _rate: float = 1.0
    _rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    n_seen: int = 0
    n_recorded: int = 0

    def record(self, latency_s: float) -> None:
        self.n_seen += 1
        # bootstrap: below min_samples the estimator abstains entirely, so
        # thinning there starves the controller of any tail signal (it would
        # hold forever once the adaptive rate decays); fill first, thin after
        if len(self._buf) >= self.min_samples \
                and self._rng.random() > self._rate:
            return
        self.n_recorded += 1
        self._buf.append(float(latency_s))
        while len(self._buf) > self.window:
            self._buf.popleft()
        if self.n_recorded % 64 == 0:
            self._adapt()

    def _adapt(self) -> None:
        p = self.p99()
        if p is None:
            return
        closeness = p / self.qos_target_s          # >= 1: violating
        if closeness > 0.8:
            self._rate = 1.0
        else:
            self._rate = max(self.min_rate, closeness)

    def record_many(self, latencies) -> None:
        """Vectorized record (thinned by the current sample rate; the first
        samples up to ``min_samples`` always land — see ``record``)."""
        import numpy as _np
        lat = _np.asarray(latencies, float)
        self.n_seen += lat.size
        need = max(0, self.min_samples - len(self._buf))
        head, tail = lat[:need], lat[need:]
        if self._rate < 1.0:
            tail = tail[self._rng.random(tail.size) <= self._rate]
        lat = _np.concatenate([head, tail])
        self.n_recorded += lat.size
        self._buf.extend(lat.tolist())
        while len(self._buf) > self.window:
            self._buf.popleft()
        self._adapt()

    def record_megastep(self, wall_s: float, tokens_per_row) -> None:
        """Attribute one megastep's wall time to per-token samples: a fused
        K-step dispatch surfaces ONE host stamp for up to K tokens per row,
        so each row that emitted ``n > 0`` tokens contributes ``n`` samples
        of ``wall_s / n`` — total mass per row equals the wall time the
        client actually experienced, and the estimator keeps seeing
        per-token latencies comparable with the per-step engine's."""
        lat = []
        for n in tokens_per_row:
            n = int(n)
            if n > 0:
                lat.extend([wall_s / n] * n)
        if lat:
            self.record_many(lat)

    def p99(self) -> Optional[float]:
        if len(self._buf) < self.min_samples:
            return None
        return float(np.percentile(np.asarray(self._buf), 99))

    def mean(self) -> Optional[float]:
        if not self._buf:
            return None
        return float(np.mean(np.asarray(self._buf)))

    def qos_violated(self) -> bool:
        p = self.p99()
        return p is not None and p > self.qos_target_s

    def slack(self) -> float:
        """(target - p99) / target; negative when violating."""
        p = self.p99()
        if p is None:
            return 0.0
        return (self.qos_target_s - p) / self.qos_target_s

    def reset_window(self) -> None:
        self._buf.clear()

    def consume_window(self):
        """One decision boundary: read the closing window's ``(p99,
        violated, slack)`` and reset so the next decision acts on fresh
        data. This is THE reset-window convention — ``PliantRuntime.
        maybe_decide`` and ``colocation.simulate`` both consume through
        here instead of each hand-rolling read-then-reset."""
        p = self.p99()
        violated = p is not None and p > self.qos_target_s
        slack = 0.0 if p is None \
            else (self.qos_target_s - p) / self.qos_target_s
        self.reset_window()
        return p, violated, slack

    @property
    def sample_rate(self) -> float:
        return self._rate
