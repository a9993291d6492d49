"""The port's megastep decode against the JAX package's, on the CPU: twin of
``tests/test_megastep.py`` on phi4-mini-3.8b-smoke in fp32, the weights
carried across by ``convert.params_from_numpy`` and the JAX ``drive`` setup
(2 slots, chunk 3, max_len 64, page 4; 5 requests, so admission runs in
waves).

The contract is the JAX package's: greedy megastep output equals the
per-step engine token for token, and temperature output is keyed by
(seed, uid, draw), so it does not depend on K. The port's sampler is a
threefry twin, so its temperature streams also equal the JAX megastep's.
On the CPU the megastep's K steps run eagerly; on the card each is a
replayed CUDA graph (``chip_smoke.py``'s megastep phase holds that path).

JAX's two donation cases have no torch meaning: the port updates the page
pool in place, so no buffer is donated or consumed. One case here asserts
that instead: the pool tensors keep their storage across megasteps. The
zamba2 and mamba2 cases of the JAX file are twinned in
``tests/test_torch_hybrid_serve.py`` and ``tests/test_torch_mamba_serve.py``;
its gemma2 cases are not twinned.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.approx.knobs import PRECISE as JAX_PRECISE
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.configs import get_config as jax_get_config
from repro.core.variants import Variant as JaxVariant
from repro.core.variants import VariantTable as JaxTable
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.core.variants import Variant, VariantTable
from repro_torch.launch import serve as t_serve
from repro_torch.serve import engine as t_engine
from repro_torch.train import step as t_step

ARCH = "phi4-mini-3.8b-smoke"
ENGINES = {"jax": jax_engine, "torch": t_engine}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return dict(jax=(jcfg, jparams), torch=(tcfg, tparams), runs={})


def prompts_for(vocab, n=5, length=7, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, length))) for _ in range(n)]


def make_engine(model, pkg, **kw):
    cfg, params = model[pkg]
    kw = dict(dict(batch_slots=2, max_len=64, prefill_chunk=3, paged=True,
                   page_size=4), **kw)
    if pkg == "jax":
        return ENGINES[pkg].ServeEngine(cfg, params=params, **kw)
    return ENGINES[pkg].ServeEngine(cfg, params=params, device="cpu", **kw)


def drive(model, pkg, prompts, max_new=5, **kw):
    """The JAX test's ``drive`` on either package: serve ``prompts`` to the
    end and return the token streams and the engine. The JAX package's
    runs are kept for the file (each compiles its executables)."""
    key = (pkg, tuple(map(tuple, prompts)), max_new,
           tuple(sorted(kw.items())))
    if pkg == "jax" and key in model["runs"]:
        return model["runs"][key]
    eng = make_engine(model, pkg, **kw)
    mod = ENGINES[pkg]
    reqs = [mod.Request(i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    eng.pool.assert_consistent()
    out = ([list(r.out) for r in reqs], eng)
    if pkg == "jax":
        model["runs"][key] = out
    return out


@pytest.mark.parametrize("k", [1, 4, 16])
def test_megastep_greedy_matches_per_step_and_jax(model, k):
    """Greedy megastep(K) equals the port's per-step engine and the JAX
    megastep engine token for token, through several admission waves."""
    prompts = prompts_for(model["torch"][0].vocab_size)
    base, _ = drive(model, "torch", prompts)
    out, eng = drive(model, "torch", prompts, megastep_k=k)
    ref, _ = drive(model, "jax", prompts, megastep_k=k)
    assert out == base == ref, (k, out, base, ref)
    assert eng.decode_dispatches > 0
    # per-row accounting: a megastep can only lower dispatches a token
    assert eng.row_dispatches / max(eng.row_tokens, 1) <= 1.0
    if k > 1:
        assert eng.row_dispatches < eng.row_tokens


@pytest.mark.parametrize("seed", [11, 12])
def test_megastep_temperature_matches_jax_and_is_invariant_in_k(model, seed):
    """Temperature 0.7: the (seed, uid, draw) threefry stream gives the JAX
    megastep's tokens at K = 1 and K = 4, the same for both K."""
    prompts = prompts_for(model["torch"][0].vocab_size, n=4, length=6,
                          seed=7)
    kw = dict(max_new=6, temperature=0.7, seed=seed)
    t1, _ = drive(model, "torch", prompts, megastep_k=1, **kw)
    t4, _ = drive(model, "torch", prompts, megastep_k=4, **kw)
    j1, _ = drive(model, "jax", prompts, megastep_k=1, **kw)
    j4, _ = drive(model, "jax", prompts, megastep_k=4, **kw)
    assert t1 == t4 == j1 == j4, (seed, t1, t4, j1, j4)


def test_megastep_temperature_seed_feeds_the_stream(model):
    prompts = prompts_for(model["torch"][0].vocab_size, n=4, length=6,
                          seed=7)
    kw = dict(max_new=6, temperature=0.7, megastep_k=4)
    a, _ = drive(model, "torch", prompts, seed=11, **kw)
    b, _ = drive(model, "torch", prompts, seed=12, **kw)
    assert a != b


def test_eos_mid_megastep_frees_slot_without_corrupting_siblings(model):
    """A row hitting EOS inside a megastep stops emitting there, its slot
    and pages are freed at the drain, and sibling rows decode on: K = 8
    equals K = 1 under the same eos_id, and the JAX megastep."""
    prompts = prompts_for(model["torch"][0].vocab_size, n=4, length=6,
                          seed=7)
    base, _ = drive(model, "torch", prompts, max_new=6, megastep_k=1)
    eos = base[0][2]    # a token seen mid-output becomes the stop id
    e1, _ = drive(model, "torch", prompts, max_new=6, megastep_k=1,
                  eos_id=eos)
    e8, eng = drive(model, "torch", prompts, max_new=6, megastep_k=8,
                    eos_id=eos)
    j8, _ = drive(model, "jax", prompts, max_new=6, megastep_k=8,
                  eos_id=eos)
    assert e1 == e8 == j8, (eos, e1, e8, j8)
    assert any(o[-1] == eos and len(o) < 6 for o in e8), e8  # early stop
    assert all(o[-1] == eos or len(o) == 6 for o in e8), e8  # none past it
    assert eng.pool.slot_pages == [[] for _ in range(eng.batch_slots)]


def test_megastep_pipeline_survives_kv_quant_swap_in_flight(model):
    """A swap across the ``kv_quant`` boundary (the pool re-encoded) asked
    for while a megastep is in flight: the port lands that megastep, drops
    its megastep state and converts the pool; every request completes with
    full-length output, the streams equal the JAX engine's under the same
    swap step, and the pool stays consistent."""
    prompts = prompts_for(model["torch"][0].vocab_size, n=4, length=6)
    tables = {"jax": JaxTable([JaxVariant(JAX_PRECISE, 1.0, 0.0),
                               JaxVariant(JaxKnobs(kv_quant=True), 0.8,
                                          0.01)]),
              "torch": VariantTable([Variant(PRECISE, 1.0, 0.0),
                                     Variant(ApproxKnobs(kv_quant=True), 0.8,
                                             0.01)])}
    outs, swap_at = {}, None
    for pkg in ("torch", "jax"):
        eng = make_engine(model, pkg, megastep_k=8, table=tables[pkg])
        reqs = [ENGINES[pkg].Request(i, prompt=list(p), max_new=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        steps = 0
        while not eng.idle:
            eng.step()
            steps += 1
            # the first step with a megastep in flight (the port's run
            # picks it, the JAX run swaps at the same step)
            if swap_at is None and eng._inflight is not None:
                swap_at = steps
            if steps == swap_at:
                assert eng._inflight is not None
                eng.request_variant(1)
            assert steps < 500
        assert swap_at is not None
        assert all(r.done and len(r.out) == 12 for r in reqs)
        assert eng.active_variant == 1
        assert any(v == 1 for (v, _) in eng._megasteps), \
            eng._megasteps.keys()
        eng.pool.assert_consistent()
        outs[pkg] = [list(r.out) for r in reqs]
        if pkg == "torch":
            assert all(c.kp.dtype == torch.int8 for c in eng.caches)
    assert outs["torch"] == outs["jax"], outs


def test_pool_tensors_keep_their_storage_across_megasteps(model):
    """The JAX package donates the caches into its megastep executable and
    asserts that the stale buffers are consumed; PyTorch has no donation:
    the megastep writes the page pool in place. So the pool is the same
    storage before, during and after a run of megasteps, and the writes
    land in it."""
    eng = make_engine(model, "torch", megastep_k=4)
    req = t_engine.Request(0, prompt=prompts_for(256)[0], max_new=6)
    eng.submit(req)
    while not req.out:          # admit until the slot decodes
        eng.step()

    def ptrs():
        return [t.data_ptr() for c in eng.caches for t in c]
    first = ptrs()
    before = [c.ppos.clone() for c in eng.caches]
    eng.step()                  # a megastep over the same tensors
    assert ptrs() == first
    eng.run()
    assert req.done and len(req.out) == 6
    assert ptrs() == first
    assert any(bool((c.ppos != b).any()) for c, b in zip(eng.caches, before))


def test_decode_megastep_matches_jax_function(model):
    """``make_paged_megastep`` against the JAX package's on the same caches
    and carry (two live rows, one with a budget that runs out mid-way, at
    temperature 0.7): the (B, K) tokens, the carry and the caches agree."""
    jcfg, jparams = model["jax"]
    tcfg, tparams = model["torch"]
    engs = {pkg: make_engine(model, pkg) for pkg in ENGINES}
    for pkg, eng in engs.items():
        for i, p in enumerate(prompts_for(256, n=2, length=6)):
            eng.submit(ENGINES[pkg].Request(i, prompt=p, max_new=12))
        while any(s is None for s in eng.slots):
            eng.step()
    assert list(engs["jax"].positions) == list(engs["torch"].positions)
    carry = dict(cur=np.array(engs["torch"].cur_tokens, np.int32),
                 pos=np.array(engs["torch"].positions, np.int32),
                 alive=np.array([True, True]), uids=np.array([0, 1],
                                                             np.int32),
                 draws=np.array([1, 1], np.int32),
                 budget=np.array([5, 2], np.int32))
    kw = dict(k=4, temperature=0.7, seed=11)
    jstep = jax.jit(jax_step.make_paged_megastep(jcfg, dynamic_scatter=True,
                                                 **kw))
    jout = jstep(jparams, *(jnp.asarray(carry[n]) for n in carry),
                 engs["jax"].caches)
    tstep = t_step.make_paged_megastep(tcfg, **kw)
    tout = tstep(tparams, *(torch.from_numpy(carry[n].copy())
                            for n in carry), engs["torch"].caches)
    # toks, cur, pos, alive, draws, budget: exactly equal
    for j, t in zip(jout[:6], tout[:6]):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert np.asarray(jout[0])[1, 2:].tolist() == [-1, -1]
    for jc, tc in zip(jout[6], caches_to_numpy(tout[6])):
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5,
                                       atol=1e-5)


def test_per_uid_rng_streams_match_fresh_generators(model):
    """The first token of a request is sampled on the host from its private
    numpy stream (``_rng_for``): the i-th draw for uid u equals the i-th
    draw of a fresh default_rng((seed, uid)), as in the JAX package."""
    eng = make_engine(model, "torch", temperature=0.8, seed=5)
    draws = {}
    for uid in (3, 9, 3, 9, 3):
        g = eng._rng_for(t_engine.Request(uid, prompt=[1], max_new=1))
        draws.setdefault(uid, []).append(g.random())
    for uid, got in draws.items():
        fresh = np.random.default_rng((5, uid))
        assert got == [fresh.random() for _ in got], uid


def test_explain_megastep_banner(model):
    eng = make_engine(model, "torch", megastep_k=6)
    s = eng.explain_megastep()
    assert "6 tokens" in s and "caches updated in place" in s \
        and "pipeline" in s and "donation" not in s
    assert "6-token megastep" in eng.explain_dispatch()
    sync = make_engine(model, "torch", megastep_k=6, sync_timing=True,
                       temperature=0.5, seed=3)
    assert "sync-timing" in sync.explain_megastep()
    assert "threefry" in sync.explain_megastep()
    off = make_engine(model, "torch")
    assert "off" in off.explain_megastep()
    assert "megastep" not in off.explain_dispatch()


def test_launch_serve_megastep_sync_timing_cpu():
    """``launch/serve.py --megastep 4 --sync-timing --device cpu``: the
    dispatch banner, every request served, and the megastep summary."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = t_serve.main(["--device", "cpu", "--arch", ARCH, "--paged",
                            "--requests", "5", "--slots", "2",
                            "--max-new", "6", "--max-len", "64",
                            "--page-size", "4", "--prefill-chunk", "8",
                            "--prompt-len", "6", "--prompt-len-max", "20",
                            "--megastep", "4", "--sync-timing"])
    out = buf.getvalue()
    assert "dispatch: megastep: up to 4 tokens fused per dispatch" in out
    assert "sync-timing drain" in out
    assert "megastep: k=4 decode_dispatches=" in out
    eng = res["engine"]
    assert all(r.done and len(r.out) == 6 for r in res["requests"])
    assert eng.megastep_k == 4 and eng.sync_timing
    assert eng.row_dispatches < eng.row_tokens


def test_weight_cache_counts_quantisations_and_drops():
    """``ops.cached_weight`` counts each quantisation it makes (a graph
    capture asserts it made none) and each cached int8 weight it drops (a
    graph holding one is recaptured): a miss, a hit, an in-place update (a
    miss that replaces, so a drop), and ``clear_weight_cache``."""
    from repro_torch.kernels import ops
    ops.clear_weight_cache()
    w = torch.randn(32, 16)
    m0, d0 = ops.weight_cache_misses, ops.weight_cache_drops
    ops.cached_weight(w)
    ops.cached_weight(w)
    assert (ops.weight_cache_misses, ops.weight_cache_drops) == (m0 + 1, d0)
    w.mul_(2.0)
    ops.cached_weight(w)
    assert (ops.weight_cache_misses, ops.weight_cache_drops) == \
        (m0 + 2, d0 + 1)
    ops.clear_weight_cache()
    assert ops.weight_cache_drops == d0 + 2
