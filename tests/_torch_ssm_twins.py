"""Shared set-up of the port's Mamba and hybrid serving twins
(``tests/test_torch_mamba_serve.py`` on mamba2-780m-smoke,
``tests/test_torch_hybrid_serve.py`` on zamba2-2.7b-smoke): the same
JAX-initialised weights in both packages, numpy-seeded workloads, and the
JAX package's engine runs, each made once per file and shared by the
tests that compare with it.

The workloads are the JAX tests': ``W1`` (5 prompts through 2 slots,
chunks of 3: tests/test_paged.py, test_megastep.py; of 6 tokens here, so
that each rung compiles one JAX admission cell), ``MIDRUN`` (5 prompts of
7 tokens, a ragged 1-token tail: tests/test_continuous.py, and
test_serve_admission.py's warmup comparison; the port
serves it through 3 slots, the JAX reference through the same 2-slot
engine, greedy streams being independent of the slot count) and
``PREFIX`` (tests/test_paged.py::test_prefix_reuse_skips_chunks).
Greedy streams are compared token for token, caches in fp32 within
``ATOL`` (sums in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jax_configs
from repro.launch.serve import serving_table as jax_serving_table
from repro.models import api as jax_api
from repro.models import lm as jax_lm
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.launch.serve import serving_table
from repro_torch.serve import engine as t_engine

ATOL = 1e-4        # fp32 logits, K/V and SSM states after a few layers
MAX_LEN = 64
_MODELS, _RUNS, _WARM = {}, {}, {}


def model(arch):
    """(JAX cfg, port cfg, JAX params, port params), made once."""
    if arch not in _MODELS:
        jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
        jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
        _MODELS[arch] = (jcfg, tcfg, jp,
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           tcfg))
    return _MODELS[arch]


def w1(vocab):
    rng = np.random.default_rng(3)
    return [list(map(int, rng.integers(1, vocab, 6))) for _ in range(5)]


def midrun(vocab):
    rng = np.random.default_rng(9)
    return [list(map(int, rng.integers(1, vocab, 7))) for _ in range(5)]


def prefix_workload(vocab):
    """Four prompts sharing an 8-token (2-page) prefix, then an exact
    duplicate of the first."""
    rng = np.random.default_rng(7)
    prefix = list(map(int, rng.integers(1, vocab, 8)))
    prompts = [prefix + list(map(int, rng.integers(1, vocab, 4)))
               for _ in range(4)]
    return prompts + [list(prompts[0])]


def swap_workload(vocab):
    rng = np.random.default_rng(21)
    return [list(map(int, rng.integers(1, vocab, 6))) for _ in range(2)]


SWAP_AT = 5        # tokens every request holds at the swap to int8+kvq8


def _serve(mod, eng, prompts, max_new, uid0=0, swap_at=0):
    """Serve ``prompts`` to the end on package ``mod``'s engine ``eng``;
    ``swap_at`` > 0: ask for int8+kvq8 once every request holds that many
    tokens (asserted, so the swap lands at the same token on every
    engine). Returns the streams (each ``max_new`` long unless a stop
    token ended it)."""
    reqs = [mod.Request(uid0 + i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while swap_at and min(len(r.out) for r in reqs) < swap_at:
        eng.step()
    if swap_at:
        assert [len(r.out) for r in reqs] == [swap_at] * len(reqs)
        eng.request_variant(2)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(map(int, r.out)) for r in reqs]


def jax_runs(arch):
    """The JAX package's dense engine on the workloads, made once: a
    2-slot engine (chunks of 3, the serving table) serves W1 on each rung
    (the caches kept after the precise run), then, back on precise, the
    prefix workload, MIDRUN and the swap scenario (2 prompts, a swap to
    int8+kvq8 when each holds ``SWAP_AT`` tokens, the rings converted with
    requests mid-decode). One engine compiles each rung's executables
    once. Returns a dict."""
    if arch in _RUNS:
        return _RUNS[arch]
    jcfg, _, jp, _ = model(arch)
    eng = jax_engine.ServeEngine(
        jcfg, params=jp, table=jax_serving_table(jcfg, slots=2,
                                                 max_len=MAX_LEN),
        batch_slots=2, max_len=MAX_LEN, prefill_chunk=3)
    out = _RUNS[arch] = {"w1": {}}
    for rung in (0, 1, 2):
        eng.request_variant(rung)
        assert eng.active_variant == rung
        out["w1"][rung] = _serve(jax_engine, eng, w1(jcfg.vocab_size), 5,
                                 100 * rung)
        if rung == 0:
            out["w1_caches"] = jax.tree.map(np.asarray, eng.caches)
    eng.request_variant(0)
    out["prefix"] = _serve(jax_engine, eng,
                           prefix_workload(jcfg.vocab_size), 5, 400)
    out["midrun"] = _serve(jax_engine, eng, midrun(jcfg.vocab_size), 6, 600)
    out["swap"] = _serve(jax_engine, eng, swap_workload(jcfg.vocab_size), 10,
                         500, swap_at=SWAP_AT)
    out["swap_log"] = list(eng.swaps)
    return out


def warmup_ref(arch, prompt, n):
    """The JAX package's token-by-token warmup (the prompt fed through
    decode steps, then greedy): tests/test_serve_admission.py's
    reference."""
    jcfg, _, jp, _ = model(arch)
    if arch not in _WARM:
        _WARM[arch] = jax.jit(lambda p, t, po, c: jax_lm.decode_step(
            p, t, po, c, jcfg))
    step = _WARM[arch]
    caches = jax_lm.init_caches(jcfg, 1, MAX_LEN, dtype=jnp.float32)
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


def port_engine(arch, *, rung=None, slots=2, **kw):
    """A port engine on the CPU (chunks of 3, max_len 64, page 4 when
    paged), on serving rung ``rung`` when given."""
    _, tcfg, _, tp = model(arch)
    kw.setdefault("prefill_chunk", 3)
    kw.setdefault("page_size", 4)
    table = (serving_table(tcfg, slots=slots, max_len=MAX_LEN)
             if rung is not None else None)
    eng = t_engine.ServeEngine(tcfg, params=tp, table=table,
                               batch_slots=slots, max_len=MAX_LEN,
                               device="cpu", **kw)
    if rung is not None:
        eng.request_variant(rung)
    return eng


def port_serve(eng, prompts, max_new, swap_at=0):
    """``_serve`` on the port's engine."""
    return _serve(t_engine, eng, prompts, max_new, swap_at=swap_at)


# (kind, engine options) of the port's serving paths held to the JAX dense
# engine's W1 streams; the megastep at K 1, 4 and 16 as tests/test_megastep.py
KINDS = {"dense": {}, "paged": dict(paged=True, n_pages=16),
         "megastep1": dict(paged=True, megastep_k=1),
         "megastep4": dict(paged=True, megastep_k=4),
         "megastep16": dict(paged=True, megastep_k=16)}
ENGINE_CASES = ([(0, k) for k in KINDS]
                + [(r, k) for r in (1, 2) for k in ("dense", "paged",
                                                    "megastep4")])


def check_engine_case(arch, rung, kind):
    """W1 on ``rung`` through the port's ``kind`` path: the JAX dense
    engine's streams token for token. The paged engine's 16-page pool
    recycles its pages; the dense engine's caches after the precise run
    equal the JAX engine's (the last requests' rings and Mamba rows)."""
    _, tcfg, _, _ = model(arch)
    eng = port_engine(arch, rung=rung, **KINDS[kind])
    got = port_serve(eng, w1(tcfg.vocab_size), 5)
    assert got == jax_runs(arch)["w1"][rung], (kind, rung, got)
    if kind == "paged":
        assert eng.pool.stats["frees"] > 0
    if kind.startswith("megastep"):
        assert eng.decode_dispatches > 0
        assert eng.row_dispatches / max(eng.row_tokens, 1) <= 1.0
    if eng.paged:
        eng.pool.assert_consistent()
    if kind == "dense" and rung == 0:
        assert_caches(eng.caches, jax_runs(arch)["w1_caches"])
    return eng


def check_snapshot_budget(arch, fit=2):
    """The prefix index's SSM snapshots stay within ``snapshot_budget``:
    a paged engine with room for ``fit`` snapshots serves the prefix
    workload (its prompts register 3 boundaries each, more than fit), and
    evicts LRU entries to stay under the budget, every entry's bytes
    accounted, with the JAX dense engine's streams."""
    _, tcfg, _, _ = model(arch)
    eng = port_engine(arch, paged=True)
    _, size = eng._mamba_snapshot(0)
    assert size > 0
    eng.pool.snapshot_budget = fit * size
    got = port_serve(eng, prefix_workload(tcfg.vocab_size), 5)
    assert got == jax_runs(arch)["prefix"]
    pool = eng.pool
    assert pool.snapshot_evicted > 0
    assert pool.peak_snapshot_bytes <= fit * size
    assert pool.snapshot_bytes == sum(e.mamba_bytes
                                      for e in pool.index.values())
    assert 0 < len(pool.index) <= fit
    pool.assert_consistent()


def assert_caches(tcaches, jcaches, atol=ATOL):
    """Leaf by leaf: fp32 within ``atol``, every other dtype equal."""
    for t, j in zip(caches_to_numpy(tcaches), jcaches):
        assert type(t).__name__ == type(j).__name__
        for name, a, b in zip(t._fields, t, j):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


def check_midrun(arch):
    """tests/test_continuous.py's scenario on the port's paged engine (3
    slots): request 0 reaches decode, the other four arrive, several
    admissions are in flight at once between decode steps, and every
    stream equals the JAX dense engine's."""
    _, tcfg, _, _ = model(arch)
    eng = port_engine(arch, slots=3, paged=True)
    reqs = [t_engine.Request(i, prompt=list(p), max_new=6)
            for i, p in enumerate(midrun(tcfg.vocab_size))]
    eng.submit(reqs[0])
    steps = 0
    while eng.slots[0] is None and steps < 50:
        eng.step()
        steps += 1
    assert eng.slots[0] is reqs[0]
    for r in reqs[1:]:
        eng.submit(r)
    concurrent, interleaved = 0, False
    while not all(r.done for r in reqs) and steps < 500:
        eng.step()
        steps += 1
        concurrent = max(concurrent, len(eng._admissions))
        interleaved |= bool(eng._admissions) and any(
            s is not None for s in eng.slots)
    assert all(r.done for r in reqs)
    assert concurrent >= 2 and interleaved
    assert [r.out for r in reqs] == jax_runs(arch)["midrun"]
    assert all(u <= b for u, b in eng.step_admission_chunks)
    eng.pool.assert_consistent()


def check_swap(arch, paged):
    """The swap scenario on the port's dense or paged engine: the JAX dense
    engine's streams and swap log; the attention caches leave the swap in
    int8, the Mamba rows in fp32 as they were."""
    _, tcfg, _, _ = model(arch)
    eng = port_engine(arch, rung=0, paged=paged)
    got = port_serve(eng, swap_workload(tcfg.vocab_size), 10,
                     swap_at=SWAP_AT)
    want = jax_runs(arch)
    assert got == want["swap"]
    assert [v for _, v in eng.swaps] == [2] and want["swap_log"][-1][1] == 2
    for c in eng.caches:
        if type(c).__name__ == "MambaCache":
            assert c.state.dtype == torch.float32
        else:
            assert c[0].dtype == torch.int8


def check_eos_megastep(arch):
    """tests/test_megastep.py's EOS case: a token seen mid-output becomes
    the stop id; K 8 equals K 1 under it, a row stops early there and
    nothing follows it, and every slot's pages are freed."""
    _, tcfg, _, _ = model(arch)
    prompts = [p[:6] for p in w1(tcfg.vocab_size)[:4]]
    base = port_serve(port_engine(arch, paged=True, megastep_k=1), prompts,
                      6)
    eos = base[0][2]
    e1 = port_serve(port_engine(arch, paged=True, megastep_k=1,
                                eos_id=eos), prompts, 6)
    eng = port_engine(arch, paged=True, megastep_k=8, eos_id=eos)
    e8 = port_serve(eng, prompts, 6)
    assert e1 == e8, (eos, e1, e8)
    assert any(o[-1] == eos and len(o) < 6 for o in e8), e8
    assert all(o[-1] == eos or len(o) == 6 for o in e8), e8
    assert eng.pool.slot_pages == [[] for _ in range(eng.batch_slots)]
