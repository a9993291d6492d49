"""The interactive services' latency model: ``ServiceProfile`` and
``SERVICES``, copied from the JAX package's ``core/colocation.py``. The
training driver draws its synthetic p99 signal from ``token-serve``; the
decision-interval simulator waits for the colocation slice.

Model:
    rho      = offered_load / capacity_boost(reclaimed chips)
    p99      = p99_iso(rho) * (1 + interf / (1 - rho))
    p99_iso  = service_time * (1 + c_q / (1 - rho))
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.variants import ResourcePressure


@dataclass(frozen=True)
class ServiceProfile:
    name: str
    qos_target_s: float
    service_time_s: float        # base per-request service time
    c_q: float                   # queueing-curve constant
    sens_mem: float              # sensitivity to HBM-bandwidth pressure
    sens_ici: float              # sensitivity to interconnect pressure
    qps_at_saturation: float
    chips_boost: float = 0.045   # capacity gain per reclaimed chip-group
    sens_flops: float = 0.05     # sensitivity to compute pressure (the p99
                                 # model is mem+ici; this only steers the
                                 # arbiter's contention attribution)

    @property
    def sensitivity(self) -> ResourcePressure:
        """The service's per-resource sensitivity vector, in the same
        ``ResourcePressure`` coordinates the tenants report pressure in."""
        return ResourcePressure(hbm=self.sens_mem, ici=self.sens_ici,
                                flops=self.sens_flops)

    def p99_iso(self, rho: float) -> float:
        rho = min(rho, 0.995)
        return self.service_time_s * (1.0 + self.c_q / (1.0 - rho))

    def p99(self, load_frac: float, interference: float,
            reclaimed_groups: int) -> float:
        boost = 1.0 + self.chips_boost * reclaimed_groups
        rho = min(load_frac / boost, 0.995)
        return self.p99_iso(rho) * (1.0 + interference / (1.0 - rho))


SERVICES = {
    # strict per-token decode SLA; decode is HBM-bound -> high mem sensitivity
    "token-serve": ServiceProfile(
        "token-serve", qos_target_s=0.020, service_time_s=0.0028, c_q=0.9,
        sens_mem=0.60, sens_ici=0.25, qps_at_saturation=48_000.0),
    # interactive search/prefill: balanced compute+collective sensitivity
    "search-prefill": ServiceProfile(
        "search-prefill", qos_target_s=0.250, service_time_s=0.036, c_q=0.9,
        sens_mem=0.42, sens_ici=0.50, qps_at_saturation=3_200.0),
    # offline-ish embedding API: large latency budget, mild sensitivity
    "embed-api": ServiceProfile(
        "embed-api", qos_target_s=1.500, service_time_s=0.30, c_q=0.55,
        sens_mem=0.30, sens_ici=0.12, qps_at_saturation=310.0),
}
