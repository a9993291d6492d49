"""The port's paged ``ServeEngine`` against the JAX package's paged engine, on
the CPU, on phi4-mini-3.8b-smoke in fp32 with the same weights
(``repro.models.api.init`` carried over by ``repro_torch.convert``).

Greedy decoding, the same prompts and the same scheduling policy give the
same token streams: the two engines must agree token for token (no
tolerance) on every rung of the serving ladder, across explicit swaps and
under runtime-driven swaps. The workload has more requests than slots, a
pool small enough to fill up and evict prefix pages, and a shared prompt
prefix."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.monitor import LatencyMonitor as JaxMonitor
from repro.core.runtime import PliantRuntime as JaxRuntime
from repro.launch.serve import serving_table as jax_serving_table
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.monitor import LatencyMonitor
from repro_torch.core.runtime import PliantRuntime
from repro_torch.launch.serve import serving_table
from repro_torch.serve import engine as t_engine

ARCH = "phi4-mini-3.8b-smoke"
SLOTS, MAX_LEN, PAGE, CHUNK, POOL = 3, 32, 4, 4, 16
MAX_NEW = 5


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    jtable = jax_serving_table(jcfg, slots=SLOTS, max_len=MAX_LEN,
                               page_occupancy=0.5)
    ttable = serving_table(tcfg, slots=SLOTS, max_len=MAX_LEN,
                           page_occupancy=0.5)
    return jcfg, tcfg, jparams, tparams, jtable, ttable


def _prompts(vocab, seed=11):
    """Six prompts (twice the slots), four of them opening with one shared
    8-token (two-page) prefix."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, vocab, 8)]
    out = []
    for i, n in enumerate((5, 9, 3, 12, 7, 10)):
        tail = [int(t) for t in rng.integers(1, vocab, n)]
        out.append(prefix + tail if i % 3 != 2 else tail + prefix[:2])
    return out


def _engines(model, *, runtime=False, max_new=MAX_NEW, n_pages=POOL):
    jcfg, tcfg, jparams, tparams, jtable, ttable = model
    jrt = trt = None
    if runtime:
        jrt = JaxRuntime(jtable, JaxMonitor(qos_target_s=1e-9, window=256,
                                            min_samples=2),
                         JaxControllerConfig(decision_interval_s=0.0))
        trt = PliantRuntime(ttable, LatencyMonitor(qos_target_s=1e-9,
                                                   window=256, min_samples=2),
                            ControllerConfig(decision_interval_s=0.0))
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
              page_size=PAGE, n_pages=n_pages)
    je = jax_engine.ServeEngine(jcfg, params=jparams, table=jtable,
                                runtime=jrt, paged=True, **kw)
    te = t_engine.ServeEngine(tcfg, params=tparams, table=ttable,
                              runtime=trt, paged=True, device="cpu", **kw)
    for eng, mod in ((je, jax_engine), (te, t_engine)):
        eng.reqs = [mod.Request(i, prompt=list(p), max_new=max_new)
                    for i, p in enumerate(_prompts(tcfg.vocab_size))]
        for r in eng.reqs:
            eng.submit(r)
    return je, te


def _run_lockstep(je, te, walk=(), every=3, max_steps=200):
    """Step both engines together. ``walk`` lists variants both engines are
    asked for in turn, the first before step ``every``, each next one
    ``every`` steps after the previous swap took effect (a swap waits while
    an admission is in flight)."""
    walk, next_at = list(walk), every
    for step in range(max_steps):
        if je.idle and te.idle:
            assert not walk, f"run ended before the swaps to {walk}"
            return
        assert je.idle == te.idle, step
        if walk and step >= next_at:
            if te.active_variant == walk[0]:
                walk.pop(0)
                next_at = step + every
            else:
                je.request_variant(walk[0])
                te.request_variant(walk[0])
        je.step()
        te.step()
        assert je.active_variant == te.active_variant, step
    raise AssertionError("engines did not drain")


def _assert_same(je, te):
    jout = {r.uid: r.out for r in je.reqs}
    tout = {r.uid: r.out for r in te.reqs}
    assert all(r.done for r in je.reqs + te.reqs)
    assert all(len(r.out) == r.max_new for r in te.reqs)
    assert tout == jout


def test_ladder_is_precise_int8_kvq8(model):
    names = [v.name for v in model[5].variants]
    assert names == ["precise", "int8", "int8+kvq8"], names


@pytest.mark.parametrize("rung", [0, 1, 2],
                         ids=["precise", "int8", "int8+kvq8"])
def test_streams_identical_on_each_rung(model, rung):
    je, te = _engines(model)
    je.set_variant(rung)
    te.set_variant(rung)
    _run_lockstep(je, te)
    _assert_same(je, te)
    # the same pool decisions; the pool filled up and evicted prefix pages,
    # and the shared prefix was hit
    assert te.stats.items() <= je.stats.items()
    assert te.pool.stats == je.pool.stats
    assert te.pool.stats["peak_used"] == te.pool.spec.usable
    assert te.pool.stats["prefix_evicted"] > 0
    assert te.pool.stats["prefix_hits"] > 0


def test_streams_identical_across_explicit_swaps(model):
    """precise -> int8+kvq8 (fp -> int8 pool conversion) -> precise (int8 ->
    fp) -> int8, mid-run, with decoders live across each swap."""
    je, te = _engines(model, max_new=8, n_pages=24)
    _run_lockstep(je, te, walk=(2, 0, 1))
    _assert_same(je, te)
    assert te.swaps == je.swaps
    assert [v for _, v in te.swaps] == [2, 0, 1], te.swaps


def test_streams_identical_under_runtime(model):
    """A QoS target no step can meet drives the runtime down the ladder and
    into pool reclaim (on the default pool: reclaim from the tight one would
    starve admission); both engines take the same decisions at the same
    steps."""
    je, te = _engines(model, runtime=True, n_pages=0)
    _run_lockstep(je, te)
    _assert_same(je, te)
    assert te.swaps == je.swaps and te.swaps, te.swaps
    jacts = [h["action"] for h in je.runtime.history]
    tacts = [h["action"] for h in te.runtime.history]
    assert tacts == jacts
    assert {"set_most_approx", "reclaim_chips"} <= set(tacts), tacts


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi4-mini-3.8b-smoke"])
@pytest.mark.parametrize("slots,max_len,occupancy",
                         [(8, 1024, 0.25), (3, 32, 0.5), (4, 64, None)])
def test_serving_tables_identical(arch, slots, max_len, occupancy):
    """Names and quality losses equal; rel_time equal up to the rounding of
    a ratio of two times priced with the H100's constants in the port and a
    TPU's in the JAX package (rel 1e-12)."""
    j = jax_serving_table(jax_configs.get_config(arch), slots=slots,
                          max_len=max_len, page_occupancy=occupancy)
    t = serving_table(t_configs.get_config(arch), slots=slots,
                      max_len=max_len, page_occupancy=occupancy)
    assert [v.name for v in t.variants] == [v.name for v in j.variants]
    assert [v.quality_loss for v in t.variants] == \
        [v.quality_loss for v in j.variants]
    assert [v.rel_time for v in t.variants] == pytest.approx(
        [v.rel_time for v in j.variants], rel=1e-12)
