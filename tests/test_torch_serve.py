"""The port's dense ``ServeEngine`` (per-slot rings, synchronous chunked
admission with a slot insert, the engine's default) against the JAX
package's, on the CPU, in fp32 with the same weights
(``repro.models.api.init`` carried over by ``repro_torch.convert``).

Twins of ``tests/test_serve.py`` (continuous batching, slot reuse,
temperature sampling, the kv_quant variant), of
``tests/test_serve_admission.py`` (admission against the token-by-token
warmup, chunk-size invariance, a forced QoS swap across the ``kv_quant``
boundary), of ``tests/test_paged.py::test_paged_matches_dense_engine`` and
``tests/test_continuous.py::test_midrun_admission_interleaves_and_matches_dense``
(the port's paged engine against the JAX dense engine), plus every serving
rung on gemma2-27b-smoke with prompts that wrap its 32-entry local rings.
Greedy streams must be equal token for token (no tolerance).

Each JAX engine run is made once and shared by the tests that compare
with it; the token-by-token warmup reference is the JAX package's decode
step, jitted once per model and variant. The serving driver's defaults
and summary are held to the JAX driver's."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.core.controller import ControllerConfig as JaxControllerConfig
from repro.core.monitor import LatencyMonitor as JaxMonitor
from repro.core.runtime import PliantRuntime as JaxRuntime
from repro.launch.serve import serving_table as jax_serving_table
from repro.models import api as jax_api
from repro.models import lm as jax_lm
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.convert import params_from_numpy
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.monitor import LatencyMonitor
from repro_torch.core.runtime import PliantRuntime
from repro_torch.launch.serve import serving_table
from repro_torch.models.attention import KVCache
from repro_torch.serve import engine as t_engine

GEMMA, PHI = "gemma2-27b-smoke", "phi4-mini-3.8b-smoke"
MAX_LEN = 64
_MODELS, _WARM, _JAX_RUNS = {}, {}, {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(arch):
    """(JAX cfg, port cfg, JAX params, port params), made once."""
    if arch not in _MODELS:
        jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
        jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
        _MODELS[arch] = (jcfg, tcfg, jp,
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           tcfg))
    return _MODELS[arch]


def warmup_ref(arch, prompt, n, kv_quant=False):
    """The JAX package's token-by-token warmup (the prompt fed through
    decode steps, then greedy): the JAX tests' reference stream."""
    jcfg, _, jp, _ = model(arch)
    key = (arch, kv_quant)
    if key not in _WARM:
        kn = JaxKnobs(kv_quant=kv_quant)
        _WARM[key] = jax.jit(lambda p, t, po, c: jax_lm.decode_step(
            p, t, po, c, jcfg, kn))
    step = _WARM[key]
    caches = jax_lm.init_caches(jcfg, 1, MAX_LEN, dtype=jnp.float32,
                                quantized=kv_quant)
    out, cursor, cur, pos = [], 0, prompt[0], 0
    while len(out) < n:
        logits, caches = step(jp, jnp.asarray([[cur]]), jnp.asarray([pos]),
                              caches)
        pos += 1
        if cursor + 1 < len(prompt):
            cursor += 1
            cur = prompt[cursor]
            continue
        cur = int(jnp.argmax(logits[0]))
        out.append(cur)
    return out


def serve(mod, arch, prompts, max_new, *, rung=None, **kw):
    """Serve ``prompts`` to the end on package ``mod``'s engine (dense
    unless ``paged=True``), on serving rung ``rung`` when given. Returns
    (streams, engine)."""
    jcfg, tcfg, jp, tp = model(arch)
    if mod is jax_engine:
        cfg, params, table_fn = jcfg, jp, jax_serving_table
    else:
        cfg, params, table_fn = tcfg, tp, serving_table
        kw.setdefault("device", "cpu")
    kw.setdefault("max_len", MAX_LEN)
    if rung is not None:
        kw["table"] = table_fn(cfg, slots=kw["batch_slots"],
                               max_len=kw["max_len"])
    eng = mod.ServeEngine(cfg, params=params, **kw)
    if rung is not None:
        eng.request_variant(rung)
    reqs = [mod.Request(i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.out) == max_new for r in reqs)
    return [list(map(int, r.out)) for r in reqs], eng


def _workload(arch):
    """Five prompts; on gemma2-27b-smoke two of them (36 and 40 tokens)
    wrap the 32-entry local rings during admission, and their decode wraps
    them again. Chunks of 8 leave tails of 4 or none (two chunk lengths,
    so the JAX engine compiles few admission cells)."""
    _, tcfg, _, _ = model(arch)
    rng = np.random.default_rng(9)
    return [list(rng.integers(1, tcfg.vocab_size, n))
            for n in (12, 36, 20, 40, 8)]


def jax_dense(arch):
    """The JAX dense engine's streams of ``_workload(arch)``, made once:
    one engine (3 slots, chunks of 8, the serving table) serves the
    workload on every rung (gemma2-27b-smoke) or on precise
    (phi4-mini-3.8b-smoke), each rung asked for by ``request_variant``
    while idle. Returns {rung: streams}."""
    if arch in _JAX_RUNS:
        return _JAX_RUNS[arch]
    jcfg, _, jp, _ = model(arch)
    eng = jax_engine.ServeEngine(
        jcfg, params=jp, table=jax_serving_table(jcfg, slots=3,
                                                 max_len=MAX_LEN),
        batch_slots=3, max_len=MAX_LEN, prefill_chunk=8)
    out = _JAX_RUNS[arch] = {}
    for rung in ((0, 1, 2) if arch == GEMMA else (0,)):
        eng.request_variant(rung)
        assert eng.active_variant == rung
        reqs = [jax_engine.Request(100 * rung + i, prompt=list(p), max_new=6)
                for i, p in enumerate(_workload(arch))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and len(r.out) == 6 for r in reqs)
        out[rung] = [list(map(int, r.out)) for r in reqs]
    return out


# ---------------------------------------------------- tests/test_serve.py --

def test_continuous_batching_matches_greedy():
    prompts = [[1 + uid, 2, 3 + uid] for uid in range(5)]  # 5 through 3 slots
    got, _ = serve(t_engine, GEMMA, prompts, 6, batch_slots=3)
    assert got == [warmup_ref(GEMMA, p, 6) for p in prompts]


def test_slot_reuse_isolated():
    """A recycled slot must not see the previous request's KV entries."""
    got, _ = serve(t_engine, GEMMA, [[5, 6, 7], [9, 10]], 4, batch_slots=1)
    assert got[1] == warmup_ref(GEMMA, [9, 10], 4)


def test_temperature_sampling():
    """Greedy ignores the seed and equals the warmup; at temperature 1 the
    host sampler's per-request streams give the JAX engine's tokens, the
    same again for the same seed and others for another seed."""
    prompts = [[4 + uid, 9] for uid in range(3)]

    def outs(temperature, seed, mod=t_engine):
        return serve(mod, GEMMA, prompts, 8, batch_slots=2,
                     temperature=temperature, seed=seed)[0]

    greedy = outs(0.0, 0)
    assert greedy == outs(0.0, 7)
    assert greedy == [warmup_ref(GEMMA, p, 8) for p in prompts]
    hot = outs(1.0, 0)
    assert hot == outs(1.0, 0, jax_engine)
    assert hot != greedy and hot != outs(1.0, 1)


def test_int8_kv_quant_variant_close():
    prompts = [[2 + uid, 3] for uid in range(2)]
    precise, _ = serve(t_engine, GEMMA, prompts, 8, batch_slots=2)
    approx, eng = serve(t_engine, GEMMA, prompts, 8, batch_slots=2,
                        knobs=ApproxKnobs(kv_quant=True))
    assert all(c.k.dtype == torch.int8 for c in eng.caches)
    assert approx == [warmup_ref(GEMMA, p, 8, kv_quant=True)
                      for p in prompts]
    agree = np.mean([a == b for ra, rb in zip(precise, approx)
                     for a, b in zip(ra, rb)])
    assert agree >= 0.5, (agree, precise, approx)


# ------------------------------------------ tests/test_serve_admission.py --

@pytest.mark.parametrize("arch", [PHI, GEMMA])
def test_admission_matches_tokenwise_warmup(arch):
    """Prompts of 7 through chunks of 3 (a ragged tail), 4 requests through
    2 slots (staggered ring offsets): the warmup's streams exactly."""
    _, tcfg, _, _ = model(arch)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, tcfg.vocab_size, 7)) for _ in range(4)]
    got, _ = serve(t_engine, arch, prompts, 5, batch_slots=2,
                   prefill_chunk=3)
    assert got == [warmup_ref(arch, p, 5) for p in prompts]


def test_admission_chunk_size_invariance():
    _, tcfg, _, _ = model(PHI)
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, tcfg.vocab_size, 9)) for _ in range(3)]
    outs = [serve(t_engine, PHI, prompts, 4, batch_slots=2,
                  prefill_chunk=c)[0] for c in (2, 9, 64)]
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] == [warmup_ref(PHI, p, 4) for p in prompts]


def _forced_swaps(pkg):
    """The JAX test's scenario on package ``pkg`` ("jax" or "port"): an
    impossible QoS target sends the runtime to the most approximate rung
    with requests mid-decode (crossing into kv_quant), then a loose one
    steps it back to precise a rung a decision (crossing out), then a late
    request is served on precise. Returns (streams, swaps, history, ring
    dtypes after each phase, engine)."""
    jcfg, tcfg, jp, tp = model(GEMMA)
    if pkg == "jax":
        mod, table = jax_engine, jax_serving_table(jcfg, slots=4,
                                                   max_len=MAX_LEN)
        runtime = JaxRuntime(table, JaxMonitor(qos_target_s=1e-7, window=256,
                                               min_samples=4),
                             JaxControllerConfig(decision_interval_s=0.0,
                                                 max_reclaim=0))
        eng = mod.ServeEngine(jcfg, batch_slots=4, max_len=MAX_LEN,
                              params=jp, runtime=runtime)
    else:
        mod, table = t_engine, serving_table(tcfg, slots=4, max_len=MAX_LEN)
        runtime = PliantRuntime(table, LatencyMonitor(
            qos_target_s=1e-7, window=256, min_samples=4),
            ControllerConfig(decision_interval_s=0.0, max_reclaim=0))
        eng = mod.ServeEngine(tcfg, batch_slots=4, max_len=MAX_LEN,
                              params=tp, runtime=runtime, device="cpu")
    reqs, dtypes = [], []

    def run(batch):
        reqs.extend(batch)
        for r in batch:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in batch)
        dtypes.append(str(eng.caches[0].k.dtype).split(".")[-1])

    run([mod.Request(i, prompt=[3 + i, 11, 7], max_new=10)
         for i in range(6)])
    runtime.monitor.qos_target_s = 1e9
    guard = 0
    while eng.active_variant != 0 and guard < 20:
        run([mod.Request(100 + guard * 10 + i, prompt=[2 + i, 5],
                         max_new=10) for i in range(4)])
        guard += 1
    run([mod.Request(999, prompt=[9, 8, 7], max_new=6)])
    return ([list(map(int, r.out)) for r in reqs], list(eng.swaps),
            [h["action"] for h in runtime.history], dtypes, eng)


def test_forced_qos_swap_crosses_kvq_boundary():
    """The port's engine makes the JAX engine's swaps at the same steps and
    gives its streams: into int8+kvq8 with requests mid-decode (the rings
    converted to int8), back to precise (converted back), then a late
    request equal to the warmup."""
    want = _forced_swaps("jax")
    got = _forced_swaps("port")
    assert got[:4] == want[:4]
    streams, swaps, actions, dtypes, eng = got
    most = len(eng._variant_knobs) - 1
    assert swaps[0][1] == most and swaps[0][0] < len(eng.step_latencies)
    assert "set_most_approx" in actions and "step_toward_precise" in actions
    assert dtypes[0] == "int8" and dtypes[-1] == "float32"
    assert eng.active_variant == 0
    assert all(isinstance(c, KVCache) for c in eng.caches)
    assert streams[-1] == warmup_ref(GEMMA, [9, 8, 7], 6)


# ------------------------- every rung, and the paged engine against dense --

@pytest.mark.parametrize("rung", [0, 1, 2],
                         ids=["precise", "int8", "int8+kvq8"])
def test_rungs_match_jax_dense_engine(rung):
    """Each serving rung of gemma2-27b-smoke, 3 slots, chunks of 8: a fresh
    port dense engine on the rung gives the streams the JAX dense engine
    gave on it (its walk precise -> int8 -> int8+kvq8, the rings converted
    at the kv_quant swap)."""
    got, eng = serve(t_engine, GEMMA, _workload(GEMMA), 6, batch_slots=3,
                     prefill_chunk=8, rung=rung)
    assert eng.pool is None and eng.active_variant == rung
    assert got == jax_dense(GEMMA)[rung]


@pytest.mark.parametrize("arch", [PHI, GEMMA])
def test_paged_matches_dense_engine(arch):
    """The port's paged engine (2 slots, chunks of 3, a 32-page pool that
    recycles its pages) gives the JAX dense engine's streams."""
    paged, eng = serve(t_engine, arch, _workload(arch), 6, batch_slots=2,
                       prefill_chunk=3, paged=True, page_size=4,
                       n_pages=32)
    assert paged == jax_dense(arch)[0]
    assert eng.pool.stats["frees"] > 0


@pytest.mark.parametrize("arch", [PHI, GEMMA])
def test_midrun_admission_interleaves_and_matches_dense(arch):
    """Requests submitted while the first is mid-decode are admitted into
    the port's paged engine chunk by chunk between decode steps, several
    in flight at once, and every stream equals the JAX dense engine's."""
    _, tcfg, _, tp = model(arch)
    prompts = _workload(arch)
    want = jax_dense(arch)[0]
    eng = t_engine.ServeEngine(tcfg, batch_slots=3, max_len=MAX_LEN,
                               params=tp, prefill_chunk=3, paged=True,
                               page_size=4, device="cpu")
    reqs = [t_engine.Request(i, prompt=list(p), max_new=6)
            for i, p in enumerate(prompts)]
    eng.submit(reqs[0])
    steps = 0
    while eng.slots[0] is None and steps < 50:   # request 0 reaches decode
        eng.step()
        steps += 1
    assert eng.slots[0] is reqs[0]
    for r in reqs[1:]:                           # arrive mid-run
        eng.submit(r)
    concurrent, interleaved = 0, False
    while not all(r.done for r in reqs) and steps < 500:
        eng.step()
        steps += 1
        live = any(s is not None for s in eng.slots)
        concurrent = max(concurrent, len(eng._admissions))
        interleaved |= bool(eng._admissions) and live
    assert all(r.done for r in reqs)
    assert concurrent >= 2 and interleaved
    assert [r.out for r in reqs] == want
    assert all(u <= b for u, b in eng.step_admission_chunks)
    eng.pool.assert_consistent()


def test_dense_engine_refuses_the_megastep():
    _, tcfg, _, tp = model(PHI)
    with pytest.raises(AssertionError, match="paged"):
        t_engine.ServeEngine(tcfg, batch_slots=2, max_len=MAX_LEN,
                             params=tp, megastep_k=4, device="cpu")


def _summary(out):
    """The printed summary's shape: each line's head (the text before its
    first ':' and lines that open with a count), and every key=value key."""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    heads = ["#" if ln[0].isdigit() else ln.split(":")[0] for ln in lines]
    return heads, set(re.findall(r"([A-Za-z][\w-]*)=", out))


def test_cli_defaults_serve_dense_like_the_jax_driver(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` with the JAX
    driver's defaults serves gemma2-27b-smoke on the dense engine and
    prints the JAX driver's summary lines and keys; ``--paged`` selects
    the paged engine and adds its two lines."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as t_serve
    jax_serve.main([])
    want = _summary(capsys.readouterr().out)
    res = t_serve.main(["--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    eng = res["engine"]
    assert eng.cfg.name == "gemma2-27b-smoke" and not eng.paged
    assert eng.pool is None and all(r.done for r in res["requests"])
    assert got == want, (got, want)
    res = t_serve.main(["--device", "cpu", "--paged", "--requests", "4"])
    heads, _ = _summary(capsys.readouterr().out)
    assert res["engine"].paged and heads[-2:] == ["paged", "admission"]


def test_cli_main_serves_a_given_config():
    """``main(argv, cfg=)`` serves ``cfg`` in place of ``--arch``'s: here
    gemma2-27b-smoke cut to one local/global pair, dense, every request
    done with its budget of tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as t_serve
    cfg = dataclasses.replace(get_config("gemma2-27b-smoke"), n_layers=2)
    res = t_serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                        "--max-new", "3"], cfg=cfg)
    eng = res["engine"]
    assert eng.cfg is cfg and len(eng.params.layers) == 2 and not eng.paged
    assert all(r.done and len(r.out) == 3 for r in res["requests"])
