"""The port's zamba2 hybrid (five Mamba2 blocks, then the one shared
attention block, a period) against the JAX package's, on the CPU, on
zamba2-2.7b-smoke in fp32 with the same weights (``repro.models.api.init``
carried over by ``repro_torch.convert``, the ``shared`` block once).

The zamba2 cases of the serving families: the paged and the dense engine
and the megastep at K 1, 4 and 16 on every serving rung (tests/
test_paged.py, test_megastep.py, test_serve_admission.py), a prefix hit
that restores an SSM snapshot, mid-run admission (test_continuous.py),
the megastep's temperature stream, a swap across ``kv_quant`` with
requests mid-decode, a pool shrink and regrow, ``prefill_with_cache``
(test_prefill.py), ``convert_caches`` (test_slots_convert.py), the paged
decode step on the pool and the Mamba rows (test_paged_kernel.py's
shared-attention dims), and the full-sequence forward, decode and training
step (test_models_smoke.py). Greedy streams are equal token for token;
logits, K/V and SSM states agree within ``ATOL`` (1e-4: fp32 sums in other
orders)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jax_lm
from repro.serve import prefill as jax_prefill
from repro.serve import slots as jax_slots
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.configs.base import SHARED_ATTN
from repro_torch.convert import caches_to_numpy, tree_to_numpy
from repro_torch.models import lm as t_lm
from repro_torch.models.mamba2 import MambaCache
from repro_torch.serve import prefill as t_prefill
from repro_torch.serve import slots as t_slots
from tests import _torch_ssm_twins as tw

ARCH = "zamba2-2.7b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_params_carry_the_shared_block_once():
    """The port's tree holds zamba2's shared attention block once (an
    empty block at each SHARED_ATTN position), its parameter count is the
    config's, and ``tree_to_numpy`` gives back the JAX tree leaf for
    leaf."""
    jcfg, tcfg, jp, tp = tw.model(ARCH)
    shared = [i for i, k in enumerate(tcfg.kinds()) if k == SHARED_ATTN]
    assert shared == [5, 11]
    assert all(not list(tp.layers[i].parameters()) for i in shared)
    assert t_lm.layer_params(tp, tcfg, 11) is tp.shared
    assert sum(p.numel() for p in tp.parameters()) == tcfg.param_count()
    back = tree_to_numpy(dict(tp.named_parameters()), tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rung,kind", tw.ENGINE_CASES,
                         ids=[f"{k}-rung{r}" for r, k in tw.ENGINE_CASES])
def test_engine_streams_match_jax_dense(rung, kind):
    tw.check_engine_case(ARCH, rung, kind)


def test_admission_matches_tokenwise_warmup():
    """The port's dense engine (prompts of 7 through chunks of 3, a ragged
    tail; 4 requests through 2 slots) gives the JAX package's
    token-by-token warmup streams."""
    _, tcfg, _, _ = tw.model(ARCH)
    prompts = tw.midrun(tcfg.vocab_size)[:4]
    got = tw.port_serve(tw.port_engine(ARCH), prompts, 5)
    assert got == [tw.warmup_ref(ARCH, p, 5) for p in prompts]


def test_prefix_reuse_skips_chunks():
    """Shared-prefix traffic on the port's paged engine: later requests map
    the registered prefix pages and start from the boundary's SSM snapshot,
    skipping those chunks, with the JAX dense engine's streams; the
    snapshots are host copies of the rows at the boundary."""
    _, tcfg, _, _ = tw.model(ARCH)
    eng = tw.port_engine(ARCH, paged=True)
    got = tw.port_serve(eng, tw.prefix_workload(tcfg.vocab_size), 5)
    assert got == tw.jax_runs(ARCH)["prefix"]
    s = eng.pool.stats
    assert s["prefix_hits"] >= 4 and s["tokens_skipped"] >= 4 * 8, s
    assert s["peak_used"] < 5 * 3 + 3, s
    snaps = [e.mamba for e in eng.pool.index.values()]
    assert snaps and all(set(m) == {0, 1, 2, 3, 4} for m in snaps)
    assert all(isinstance(r, MambaCache) for m in snaps for r in m.values())


@pytest.mark.parametrize("fit", [1, 2])
def test_snapshot_budget_bounds_prefix_snapshots(fit):
    tw.check_snapshot_budget(ARCH, fit)


def test_midrun_admission_interleaves_and_matches_dense():
    tw.check_midrun(ARCH)


def test_megastep_temperature_stream_invariant_in_k():
    """At temperature 0.7 the (seed, uid, draw) keyed sampler makes K 1 and
    K 4 megasteps emit the same tokens, and another seed others."""
    _, tcfg, _, _ = tw.model(ARCH)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, tcfg.vocab_size, 6)))
               for _ in range(4)]

    def run(k, seed):
        return tw.port_serve(tw.port_engine(
            ARCH, paged=True, megastep_k=k, temperature=0.7, seed=seed),
            prompts, 6)
    t4 = run(4, 11)
    assert run(1, 11) == t4
    assert run(4, 12) != t4


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_across_kv_quant_mid_decode(paged):
    tw.check_swap(ARCH, paged)


def test_pool_shrink_regrow_roundtrip():
    """A pool_pages shrink and regrow mid-decode keeps every stream equal
    to the JAX dense engine's (tests/test_paged.py's zamba2 case)."""
    _, tcfg, _, _ = tw.model(ARCH)
    eng = tw.port_engine(ARCH, paged=True)
    from repro_torch.serve.engine import Request
    reqs = [Request(i, prompt=list(p), max_new=5)
            for i, p in enumerate(tw.w1(tcfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    eng.pool.set_reclaimed(eng.pool.max_quanta)
    for _ in range(3):
        eng.step()
    eng.pool.set_reclaimed(0)
    eng.run()
    assert [r.out for r in reqs] == tw.jax_runs(ARCH)["w1"][0]
    assert eng.pool.stats["reclaim_events"] == 2
    assert [e["action"] for e in eng.pool.stats["reclaim_log"]] == \
        ["shrink", "grow"]


def test_prefill_handoff_matches_jax():
    """``prefill_with_cache`` of 2 x 12 tokens: logits, the shared layers'
    rings and the Mamba rows within ATOL of the JAX package's; one decode
    step from them within the JAX test's 3e-3 of one from the port's
    token-by-token warmup."""
    jcfg, tcfg, jp, tp = tw.model(ARCH)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 12))
    jl, jc = jax.jit(lambda p, t: jax_prefill.prefill_with_cache(
        p, t, jcfg, 32))(jp, jnp.asarray(toks, jnp.int32))
    tl, tc = t_prefill.prefill_with_cache(tp, torch.from_numpy(toks), tcfg,
                                          32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tw.ATOL,
                               rtol=0)
    tw.assert_caches(tc, jc)
    nxt = np.array(jnp.argmax(jl, -1))[:, None]
    pos = np.full((2,), 12, np.int32)
    to, _ = t_lm.decode_step(tp, torch.from_numpy(nxt),
                             torch.from_numpy(pos), tc, tcfg)
    wc = t_lm.init_caches(tcfg, 2, 32, dtype=torch.float32)
    for i in range(12):
        wl, wc = t_lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                  torch.full((2,), i, dtype=torch.int32),
                                  wc, tcfg)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), rtol=3e-3, atol=3e-3)
    wo, _ = t_lm.decode_step(tp, torch.from_numpy(nxt),
                             torch.from_numpy(pos), wc, tcfg)
    np.testing.assert_allclose(to.numpy(), wo.numpy(), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_convert_roundtrip_smoke(paged):
    """Twin of tests/test_slots_convert.py on zamba2: fp32 -> int8 -> fp32
    -> int8 in both packages, each tree equal to JAX's; the shared layers'
    K/V idempotent across int8 -> fp32 -> int8, positions, cursors, block
    tables and Mamba rows carried bit for bit."""
    _, tcfg, _, _ = tw.model(ARCH)
    rng = np.random.default_rng(0)
    shape = (t_lm.init_paged_caches(tcfg, 2, 8, 4, 2, dtype=torch.float32)
             if paged else t_lm.init_caches(tcfg, 2, 8, dtype=torch.float32))
    leaves = []
    for c in shape:
        lv = [rng.standard_normal(x.shape).astype(np.float32)
              if x.dtype == torch.float32 else
              rng.integers(0, 4, x.shape).astype(np.int32) for x in c]
        leaves.append(lv)
    jmods = {"KVCache": "attention", "PagedKVCache": "attention",
             "MambaCache": "mamba2"}
    import importlib
    jt = [getattr(importlib.import_module(
        "repro.models." + jmods[type(c).__name__]), type(c).__name__)
        for c in shape]
    j0 = tuple(t(*map(jnp.asarray, lv)) for t, lv in zip(jt, leaves))
    t0 = tuple(type(c)(*(torch.from_numpy(v.copy()) for v in lv))
               for c, lv in zip(shape, leaves))
    jchain, tchain = [j0], [t0]
    for q in (True, False, True):
        jchain.append(jax_slots.convert_caches(jchain[-1], q))
        tchain.append(t_slots.convert_caches(tchain[-1], q))
        tw.assert_caches(tchain[-1], jchain[-1], atol=0)
    _, q1, _, q2 = tchain
    for a, b in zip(q1, q2):
        if isinstance(a, MambaCache):
            continue
        assert a[0].dtype == torch.int8
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for chain in tchain[1:]:
        for c0, c in zip(t0, chain):
            keep = range(3) if isinstance(c0, MambaCache) else (2, 3)
            assert all(torch.equal(c0[i], c[i]) for i in keep)


def test_paged_decode_step_matches_jax():
    """One paged ``decode_step`` on zamba2 (the shared block over the pool
    through ``paged_attention``'s plain version at its MHA dims, the Mamba
    rows where-masked): two slots with 8 positions on pages and the page
    of position 8 mapped, random entries, slot 1 inactive (its write
    parked on the never-read null page 0). Logits within ATOL of the JAX
    package's, the caches (every page but the null page, positions, Mamba
    rows) too, slot 1's Mamba rows and pages bit for bit as they were."""
    jcfg, tcfg, jp, tp = tw.model(ARCH)
    rng = np.random.default_rng(5)
    shape = t_lm.init_paged_caches(tcfg, 2, 8, 4, 4, dtype=torch.float32)
    leaves = []
    for c in shape:
        if isinstance(c, MambaCache):
            leaves.append([rng.normal(size=x.shape).astype(np.float32) * 0.5
                           for x in c])
            continue
        ppos = np.full(c.ppos.shape, -1, np.int32)
        block = np.zeros(c.block.shape, np.int32)
        block[:, 0, :3], block[:, 1, :3] = (1, 2, 5), (3, 4, 6)
        for pid, base in ((1, 0), (2, 4), (3, 0), (4, 4)):
            ppos[:, pid] = np.arange(base, base + 4)
        leaves.append([rng.normal(size=c.kp.shape).astype(np.float32),
                       rng.normal(size=c.vp.shape).astype(np.float32),
                       ppos, block])
    from repro.models import attention as jax_attn
    from repro.models import mamba2 as jax_mamba
    jc = tuple((jax_mamba.MambaCache if isinstance(c, MambaCache)
                else jax_attn.PagedKVCache)(*map(jnp.asarray, lv))
               for c, lv in zip(shape, leaves))
    tc = tuple(type(c)(*(torch.from_numpy(v.copy()) for v in lv))
               for c, lv in zip(shape, leaves))
    before = caches_to_numpy(tc)
    toks = np.array([[7], [9]])
    pos = np.array([8, 8], np.int32)
    act = np.array([True, False])
    jl, jn = jax.jit(lambda p, t, po, c, a: jax_lm.decode_step(
        p, t, po, c, jcfg, active=a))(jp, jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(pos), jc, jnp.asarray(act))
    tl, tn = t_lm.decode_step(tp, torch.from_numpy(toks),
                              torch.from_numpy(pos), tc, tcfg,
                              active=torch.from_numpy(act))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                               atol=tw.ATOL, rtol=0)
    def real(c):        # every page but the null page
        return c._replace(kp=c.kp[:, 1:], vp=c.vp[:, 1:], ppos=c.ppos[:, 1:])
    tw.assert_caches([c if isinstance(c, MambaCache) else real(c)
                      for c in tn],
                     [c if isinstance(c, jax_mamba.MambaCache) else real(c)
                      for c in jn])
    for b, a in zip(before, caches_to_numpy(tn)):
        if type(a).__name__ == "MambaCache":
            for x, y in zip(b, a):
                np.testing.assert_array_equal(x[:, 1], y[:, 1])
        else:
            for i in (0, 1):            # slot 1's pages: kp, vp
                np.testing.assert_array_equal(a[i][:, [3, 4, 6]],
                                              b[i][:, [3, 4, 6]])


def test_decode_matches_full_forward_and_train_step():
    """Twins of tests/test_models_smoke.py's zamba2 cases: 16 decode steps
    on dense caches give the full-sequence forward's last logits (the JAX
    test's 3e-3); one training step on precise (no remat), its loss within
    1e-5 of the JAX package's ``lm_loss``, and one on int8 + token drop
    50% + layer skip 50%: finite losses and gradient norms, every precise
    parameter moved."""
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    jcfg, tcfg, jp, tp = tw.model(ARCH)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 17))
    h, _ = t_lm.forward_hidden(tp, torch.from_numpy(toks[:, :16]), tcfg,
                               remat="none")
    want = t_lm.logits_fn(tp, h[:, -1], tcfg)
    caches = t_lm.init_caches(tcfg, 2, 16, dtype=torch.float32)
    for i in range(16):
        got, caches = t_lm.decode_step(
            tp, torch.from_numpy(toks[:, i:i + 1]),
            torch.full((2,), i, dtype=torch.int32), caches, tcfg)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=3e-3, atol=3e-3)
    jloss, _ = jax.jit(lambda p, t: jax_lm.lm_loss(
        p, {"tokens": t}, jcfg, remat="none"))(jp, jnp.asarray(toks))
    approx = dict(matmul_precision="int8", token_drop=0.5, layer_skip=0.5)
    for kn in ({}, approx):
        params = copy.deepcopy(tp)
        before = {k: v.clone() for k, v in params.named_parameters()}
        step = make_train_step(tcfg, ApproxKnobs(**kn),
                               opt_cfg=optim.OptConfig(lr=1e-3, warmup=2,
                                                       total_steps=10),
                               remat="none")
        params, opt, m = step(params, optim.init_opt(params),
                              {"tokens": torch.from_numpy(toks)})
        loss = float(m["loss"])
        assert np.isfinite(loss) and np.isfinite(float(m["grad_norm"]))
        assert int(opt.step) == 1
        if not kn:
            assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss)), \
                (loss, float(jloss))
            assert all(not torch.equal(v, before[k])
                       for k, v in params.named_parameters())
