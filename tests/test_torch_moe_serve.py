"""The port's serving engines on an MoE model against the JAX package's, on
the CPU: olmoe-1b-7b-smoke (8 experts, top-2) with the same
JAX-initialised fp32 weights in both packages.

The serving table is the explorer's (precise, int8, int8+kvq8) with a
``topk1`` rung (expert perforation) appended, in both packages. Greedy
streams are compared token for token with the JAX package's dense engine
(2 slots, chunks of 3), run once per file: ``W1`` (5 prompts of 6 tokens)
on every rung through the port's dense and paged engines and the megastep
at K 1 and 4; a swap precise -> topk1 -> int8+kvq8 with the requests
mid-decode (the second swap crosses ``kv_quant`` and ``topk`` at once);
and chunked admission at capacity factor 0.25 with chunks of 32 tokens,
where a chunk routes more entries to an expert than its capacity and
drops them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.configs.base import MoEConfig as JaxMoE
from repro.core.variants import Variant as JaxVariant
from repro.core.variants import VariantTable as JaxTable
from repro.launch.serve import serving_table as jax_serving_table
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.variants import Variant, VariantTable
from repro_torch.launch.serve import serving_table
from repro_torch.models import moe as t_moe
from repro_torch.serve import engine as t_engine

ARCH = "olmoe-1b-7b-smoke"
MAX_LEN = 64
TOPK1 = 3                      # the topk1 rung's index
SWAPS = ((3, TOPK1), (6, 2))   # (tokens every request holds, rung)
TIGHT_CF, TIGHT_CHUNK, TIGHT_LEN = 0.25, 32, 40
_MODELS, _RUNS = {}, {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(cf=None):
    """(JAX cfg, port cfg, JAX params, port params) at capacity factor
    ``cf`` (the config's for None), made once."""
    if cf not in _MODELS:
        jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
        if cf is not None:
            m = tcfg.moe
            jcfg = dataclasses.replace(
                jcfg, moe=JaxMoE(m.n_experts, m.top_k, capacity_factor=cf))
            tcfg = dataclasses.replace(
                tcfg, moe=MoEConfig(m.n_experts, m.top_k, capacity_factor=cf))
        if cf is None:
            jp = jax.jit(lambda k: jax_api.init(jcfg, k, jnp.float32))(
                jax.random.PRNGKey(0))      # the eager init's values
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
        else:           # the capacity factor changes no parameter
            jp, tp = model()[2:]
        _MODELS[cf] = (jcfg, tcfg, jp, tp)
    return _MODELS[cf]


def tables(jcfg, tcfg):
    """The explorer's serving tables plus a topk1 rung (its price from the
    explorer's precise-relative time is not needed by the engines)."""
    jt = jax_serving_table(jcfg, slots=2, max_len=MAX_LEN)
    tt = serving_table(tcfg, slots=2, max_len=MAX_LEN)
    assert [v.name for v in tt.variants] == ["precise", "int8", "int8+kvq8"]
    jt = JaxTable(jt.variants + [JaxVariant(JaxKnobs(topk_override=1),
                                            0.7, 0.011)])
    tt = VariantTable(tt.variants + [Variant(ApproxKnobs(topk_override=1),
                                             0.7, 0.011)])
    return jt, tt


def w1(vocab):
    rng = np.random.default_rng(3)
    return [list(map(int, rng.integers(1, vocab, 6))) for _ in range(5)]


def swap_workload(vocab):
    rng = np.random.default_rng(21)
    return [list(map(int, rng.integers(1, vocab, 6))) for _ in range(2)]


def tight_workload(vocab):
    rng = np.random.default_rng(17)
    return [list(map(int, rng.integers(1, vocab, TIGHT_LEN)))
            for _ in range(3)]


def serve(mod, eng, prompts, max_new, uid0=0, swaps=()):
    """Serve ``prompts`` to the end on package ``mod``'s engine; each
    ``(at, rung)`` of ``swaps`` asks for ``rung`` once every request holds
    ``at`` tokens (asserted, so the swap lands at the same token on every
    engine)."""
    reqs = [mod.Request(uid0 + i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for at, rung in swaps:
        while min(len(r.out) for r in reqs) < at:
            eng.step()
        assert [len(r.out) for r in reqs] == [at] * len(reqs)
        eng.request_variant(rung)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(map(int, r.out)) for r in reqs]


def jax_runs():
    """The JAX dense engine's streams, made once: W1 on each rung and the
    swap scenario on one 2-slot engine (chunks of 3), and the tight
    workload on one at capacity factor ``TIGHT_CF`` (chunks of
    ``TIGHT_CHUNK``)."""
    if _RUNS:
        return _RUNS
    jcfg, _, jp, _ = model()
    jt, _ = tables(jcfg, model()[1])
    eng = jax_engine.ServeEngine(jcfg, params=jp, table=jt, batch_slots=2,
                                 max_len=MAX_LEN, prefill_chunk=3)
    _RUNS["w1"] = {}
    for rung in range(len(jt.variants)):
        eng.request_variant(rung)
        assert eng.active_variant == rung
        _RUNS["w1"][rung] = serve(jax_engine, eng, w1(jcfg.vocab_size), 5,
                                  100 * rung)
    eng.request_variant(0)
    _RUNS["swap"] = serve(jax_engine, eng, swap_workload(jcfg.vocab_size),
                          10, 500, swaps=SWAPS)
    _RUNS["swap_log"] = [v for _, v in eng.swaps][-2:]
    jcfg, tcfg, jp, _ = model(TIGHT_CF)
    eng = jax_engine.ServeEngine(jcfg, params=jp, batch_slots=2,
                                 max_len=MAX_LEN, prefill_chunk=TIGHT_CHUNK)
    _RUNS["tight"] = serve(jax_engine, eng, tight_workload(jcfg.vocab_size),
                           6)
    return _RUNS


def port_engine(cf=None, rung=0, **kw):
    jcfg, tcfg, _, tp = model(cf)
    kw.setdefault("prefill_chunk", 3)
    table = tables(jcfg, tcfg)[1] if cf is None else None
    eng = t_engine.ServeEngine(tcfg, params=tp, table=table, batch_slots=2,
                               max_len=MAX_LEN, page_size=4, device="cpu",
                               **kw)
    if table is not None:
        eng.request_variant(rung)
    return eng


KINDS = {"dense": {}, "paged": dict(paged=True, n_pages=16),
         "megastep1": dict(paged=True, megastep_k=1),
         "megastep4": dict(paged=True, megastep_k=4)}
CASES = ([(r, k) for r in range(4) for k in ("dense", "paged")]
         + [(0, "megastep1"), (0, "megastep4"), (TOPK1, "megastep4")])


@pytest.mark.parametrize("rung,kind", CASES)
def test_engine_streams_equal_jax(rung, kind):
    """W1 on each rung (a topk1 rung included) through the port's dense
    and paged engines and the megastep: the JAX dense engine's streams."""
    eng = port_engine(rung=rung, **KINDS[kind])
    got = serve(t_engine, eng, w1(model()[1].vocab_size), 5)
    assert got == jax_runs()["w1"][rung], (rung, kind, got)
    assert eng.active_knobs.topk_override == (1 if rung == TOPK1 else 0)
    if kind.startswith("megastep"):
        assert eng.decode_dispatches > 0
    if eng.paged:
        eng.pool.assert_consistent()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_across_topk_and_kv_quant_mid_decode(paged):
    """precise -> topk1 -> int8+kvq8 with both requests mid-decode (the
    second swap converts the caches to int8 and restores top-2 routing):
    the JAX dense engine's streams and swaps."""
    eng = port_engine(paged=paged)
    got = serve(t_engine, eng, swap_workload(model()[1].vocab_size), 10,
                swaps=SWAPS)
    assert got == jax_runs()["swap"]
    assert [v for _, v in eng.swaps] == jax_runs()["swap_log"] == [TOPK1, 2]
    assert all(c.k.dtype == torch.int8 if not paged else c.kp.dtype ==
               torch.int8 for c in eng.caches)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_admission_chunk_overflowing_capacity(paged, monkeypatch):
    """Capacity factor 0.25 and chunks of 32 tokens: some admission chunk
    routes more entries to an expert than its capacity (8 slots) and
    drops them; the streams are the JAX dense engine's all the same."""
    dropped = []
    route = t_moe._route

    def spy(x2, *a):
        out = route(x2, *a)
        if x2.shape[0] == TIGHT_CHUNK:
            dropped.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(t_moe, "_route", spy)
    eng = port_engine(TIGHT_CF, prefill_chunk=TIGHT_CHUNK, paged=paged)
    got = serve(t_engine, eng, tight_workload(model(TIGHT_CF)[1].vocab_size),
                6)
    assert got == jax_runs()["tight"]
    assert dropped and max(dropped) > 0, dropped
