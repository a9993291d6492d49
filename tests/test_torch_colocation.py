"""The port's colocation simulator (``repro_torch.core.colocation``) against
the JAX package's (``repro.core.colocation``): a twin of
``tests/test_colocation.py``, every test function with its
parametrisation.

The simulator is deterministic numpy over copies of the same monitor,
arbiter, explorer and tenants, so the two packages must give the same
numbers: the explorer's tables for the four archs at ``train_4k`` (names,
``rel_time``, ``quality_loss``, pressure) and every ``simulate`` timeline
(p99, variants, reclaimed counts, actions) to 1e-12, anything short of
that being a fault of the copy. The JAX side runs once for the file in a
subprocess (``conftest.subproc``), through the same ``_cases`` function as
the port's side; Python's string hash differs from process to process, so
``test_pliant_quality_loss_near_paper_average``'s seeds are computed here
and handed to both. Each test then holds the port's result to the JAX
test's own bounds."""
import inspect
import json

import numpy as np
import pytest

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import colocation
from repro_torch.core.explorer import explore

ARCHS = ["phi4-mini-3.8b", "mamba2-780m", "olmoe-1b-7b", "gemma2-27b"]
SVCS = ["token-serve", "search-prefill", "embed-api"]
# paper violation bands under precise colocation (Fig. 5), as in the JAX
# test: memcached 1.46-3.8x, NGINX 2.1-9.8x, MongoDB 2.08-5.91x
BANDS = {"token-serve": (1.2, 4.5), "search-prefill": (1.4, 10.5),
         "embed-api": (1.1, 6.5)}
TOL = 1e-12
SEEDS = {f"{s}|{a}": hash((s, a)) % 2 ** 31 for s in SVCS for a in ARCHS}


def _cases(colo, get_config, SHAPES, explore, archs, svcs, seeds):
    """Every explorer table and simulation ``tests/test_colocation.py``
    makes, as plain JSON values, through one package's modules."""
    def job(arch, serving=False):
        table = explore(get_config(arch), SHAPES["train_4k"], serving=serving)
        return colo.BatchJob(name=arch, table=table, total_work=300.0)

    def sim(res):
        return dict(
            timeline=[[p.t, p.p99, list(p.variants), list(p.reclaimed),
                       p.action] for p in res.timeline],
            qos_met_frac=res.qos_met_frac,
            max_reclaimed=list(res.max_reclaimed),
            exec_time=res.exec_time(0),
            quality_loss=[j.quality_loss for j in res.jobs],
            finished_at=[j.finished_at for j in res.jobs])

    out = {"tables": {}}
    for arch in archs:
        t = explore(get_config(arch), SHAPES["train_4k"])
        out["tables"][arch] = [
            [v.name, v.rel_time, v.quality_loss,
             [v.pressure.hbm, v.pressure.ici, v.pressure.flops]]
            for v in t.variants]
    for s in svcs:
        svc = colo.SERVICES[s]
        for arch in ["phi4-mini-3.8b", "mamba2-780m", "olmoe-1b-7b"]:
            out[f"band|{s}|{arch}"] = sim(colo.simulate(
                svc, [job(arch)], precise_only=True, horizon_s=60, seed=1))
        out[f"meets|{s}"] = sim(colo.simulate(
            svc, [job("phi4-mini-3.8b")], horizon_s=360, seed=2))
        for arch in archs:
            out[f"avg|{s}|{arch}"] = sim(colo.simulate(
                svc, [job(arch)], horizon_s=300, seed=seeds[f"{s}|{arch}"]))
        for arb in ("round_robin", "interference"):
            for seed in (4, 6):
                out[f"arb|{s}|{arb}|{seed}"] = sim(colo.simulate(
                    svc, colo.archetype_jobs(), horizon_s=300, seed=seed,
                    arbiter=arb))
    out["lenient"] = sim(colo.simulate(
        colo.SERVICES["embed-api"], [job("mamba2-780m")], horizon_s=300,
        seed=3, load_frac=0.55))
    out["strict"] = sim(colo.simulate(
        colo.SERVICES["token-serve"], [job("mamba2-780m")], horizon_s=300,
        seed=3, load_frac=0.775))
    jobs = [job("phi4-mini-3.8b"), job("olmoe-1b-7b"), job("mamba2-780m")]
    for j in jobs:
        j.total_work = 900.0
    out["multiapp"] = sim(colo.simulate(colo.SERVICES["search-prefill"],
                                        jobs, horizon_s=420, seed=4))
    jobs = [job("phi4-mini-3.8b"), job("olmoe-1b-7b")]
    jobs[0].chip_groups = 2
    jobs[1].chip_groups = 24
    for j in jobs:
        j.total_work = 5000.0
    out["budgets"] = sim(colo.simulate(colo.SERVICES["token-serve"], jobs,
                                       horizon_s=120, seed=6, load_frac=0.95))
    for interval in [0.5, 1.0, 8.0]:
        out[f"interval|{interval}"] = sim(colo.simulate(
            colo.SERVICES["token-serve"], [job("phi4-mini-3.8b")],
            horizon_s=360, interval_s=interval, seed=5))
    j = job("phi4-mini-3.8b")
    svc = colo.SERVICES["token-serve"]
    i_precise = colo.interference_of([j], svc)
    j.variant = len(j.table) - 1
    out["interference"] = [i_precise, colo.interference_of([j], svc)]
    out["reclaim_p99"] = [svc.p99(0.775, 0.3, 0), svc.p99(0.775, 0.3, 4)]
    return out


@pytest.fixture(scope="module")
def both(subproc):
    """(port, jax): ``_cases`` through each package."""
    code = (
        "import json\n"
        "from repro.configs import get_config\n"
        "from repro.configs.base import SHAPES\n"
        "from repro.core import colocation as colo\n"
        "from repro.core.explorer import explore\n"
        + inspect.getsource(_cases) +
        f"out = _cases(colo, get_config, SHAPES, explore, {ARCHS!r}, "
        f"{SVCS!r}, {SEEDS!r})\n"
        "print('CASES ' + json.dumps(out))\n")
    line = next(x for x in subproc(code).splitlines()
                if x.startswith("CASES "))
    want = json.loads(line[len("CASES "):])
    got = json.loads(json.dumps(_cases(colocation, get_config, SHAPES,
                                       explore, ARCHS, SVCS, SEEDS)))
    assert got.keys() == want.keys()
    return got, want


def _same(got, want, what):
    """Equal structure and strings; floats within ``TOL``."""
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= TOL, (what, got, want)
    else:
        assert got == want, (what, got, want)


def _twin(both, *keys):
    got, want = both
    for k in keys:
        _same(got[k], want[k], k)
    return [got[k] for k in keys]


@pytest.mark.parametrize("arch", ARCHS)
def test_explore_tables_match_jax(both, arch):
    got, want = both
    _same(got["tables"][arch], want["tables"][arch], arch)
    names = [v[0] for v in got["tables"][arch]]
    assert names[0] == "precise" and len(names) > 1, names


@pytest.mark.parametrize("svc_name", SVCS)
def test_precise_colocation_violates_in_band(both, svc_name):
    svc = colocation.SERVICES[svc_name]
    lo, hi = BANDS[svc_name]
    for arch in ["phi4-mini-3.8b", "mamba2-780m", "olmoe-1b-7b"]:
        (res,) = _twin(both, f"band|{svc_name}|{arch}")
        mult = np.median([p[1] for p in res["timeline"]]) / svc.qos_target_s
        assert lo <= mult <= hi, (svc_name, arch, mult)


@pytest.mark.parametrize("svc_name", SVCS)
def test_pliant_meets_qos(both, svc_name):
    svc = colocation.SERVICES[svc_name]
    (res,) = _twin(both, f"meets|{svc_name}")
    median_p99 = float(np.median([p[1] for p in res["timeline"][3:]]))
    assert median_p99 <= svc.qos_target_s * 1.02, (svc_name, median_p99)
    assert res["qos_met_frac"] > 0.7, (svc_name, res["qos_met_frac"])
    assert res["quality_loss"][0] <= 0.055, res["quality_loss"]


def test_pliant_quality_loss_near_paper_average(both):
    losses = [r["quality_loss"][0] for r in _twin(
        both, *[f"avg|{s}|{a}" for s in SVCS for a in ARCHS])]
    assert np.mean(losses) < 0.04, np.mean(losses)
    assert max(losses) <= 0.055, max(losses)


def test_lenient_service_allows_precise_mode(both):
    res, res2 = _twin(both, "lenient", "strict")
    precise_frac = np.mean([p[2][0] == 0 for p in res["timeline"]])
    strict_frac = np.mean([p[2][0] == 0 for p in res2["timeline"]])
    assert precise_frac > 0.3, precise_frac
    assert precise_frac > strict_frac, (precise_frac, strict_frac)


def test_multiapp_round_robin_balances_losses(both):
    svc = colocation.SERVICES["search-prefill"]
    (res,) = _twin(both, "multiapp")
    median_p99 = float(np.median([p[1] for p in res["timeline"][5:]]))
    assert median_p99 <= svc.qos_target_s * 1.05
    assert res["qos_met_frac"] > 0.65
    losses = res["quality_loss"]
    assert max(losses) - min(losses) < 0.03, losses
    assert all(x <= 0.055 for x in losses)


def test_per_tenant_reclaim_budgets_in_sim(both):
    (res,) = _twin(both, "budgets")
    assert res["max_reclaimed"][0] <= 1, res["max_reclaimed"]
    assert res["max_reclaimed"][1] > 1, res["max_reclaimed"]


@pytest.mark.parametrize("svc_name", SVCS)
def test_interference_aware_at_least_matches_round_robin(both, svc_name):
    agg = {}
    for arb in ("round_robin", "interference"):
        runs = _twin(both, *[f"arb|{svc_name}|{arb}|{s}" for s in (4, 6)])
        agg[arb] = (float(np.mean([r["qos_met_frac"] for r in runs])),
                    float(np.mean([np.mean(r["quality_loss"])
                                   for r in runs])))
    (rr_q, rr_l), (ia_q, ia_l) = agg["round_robin"], agg["interference"]
    assert ia_q >= rr_q, agg
    assert ia_l <= rr_l, agg
    assert ia_l <= 0.021, agg


def test_decision_interval_sensitivity(both):
    fracs = {i: r["qos_met_frac"] for i, r in zip(
        (0.5, 1.0, 8.0), _twin(both, *[f"interval|{i}"
                                       for i in (0.5, 1.0, 8.0)]))}
    assert fracs[0.5] >= fracs[8.0]
    assert fracs[1.0] >= fracs[8.0]


def test_interference_drops_with_approximation(both):
    ((i_precise, i_approx),) = _twin(both, "interference")
    assert i_approx < i_precise


def test_chip_reclamation_helps_when_approx_insufficient(both):
    ((base, reclaimed),) = _twin(both, "reclaim_p99")
    assert reclaimed < base
