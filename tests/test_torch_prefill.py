"""The port's dense prefill handoff, slot insert and cache conversion
against the JAX package's, on the CPU.

``prefill_with_cache`` (one full-sequence forward that hands dense rings
to decode; twins of ``tests/test_prefill.py``'s attention cases and its
window ring layout), ``serve.slots.insert_request`` at cursors whose
difference wraps the ring, and ``serve.slots.convert_caches`` on dense
rings and the page pool (twin of ``tests/test_slots_convert.py`` on
phi4-mini-3.8b-smoke, the smoke cases and the hypothesis property). The
same weights and numpy-seeded inputs go through both packages: fp32 logits
and K/V within 1e-5, int8 K/V, positions, cursors and block tables equal
bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import lm as jax_lm
from repro.serve import prefill as jax_prefill
from repro.serve import slots as jax_slots
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import lm as t_lm
from repro_torch.serve import prefill as t_prefill
from repro_torch.serve import slots as t_slots

ATOL = 1e-5
PHI, GEMMA = "phi4-mini-3.8b-smoke", "gemma2-27b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, **kw):
    jcfg = dataclasses.replace(jax_configs.get_config(arch), **kw)
    tcfg = dataclasses.replace(t_configs.get_config(arch), **kw)
    jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             tcfg)


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


def _handoff(model, S, max_len, knobs=None, B=2):
    """``prefill_with_cache`` of B x S tokens in both packages, then one
    decode step from the handed-off rings; and the port's token-by-token
    warmup of the same tokens on ``init_caches`` rings."""
    jcfg, tcfg, jp, tp = model
    jk, tk = JaxKnobs(**(knobs or {})), ApproxKnobs(**(knobs or {}))
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    jl, jc = jax.jit(lambda p, t: jax_prefill.prefill_with_cache(
        p, t, jcfg, max_len, jk))(jp, jnp.asarray(toks, jnp.int32))
    tl, tc = t_prefill.prefill_with_cache(tp, torch.from_numpy(toks), tcfg,
                                          max_len, tk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert_caches(tc, jc)
    nxt = np.array(jnp.argmax(jl, -1))[:, None]
    pos = np.full((B,), S, np.int32)
    jo, _ = jax_lm.decode_step(jp, jnp.asarray(nxt, jnp.int32),
                               jnp.asarray(pos), jc, jcfg, jk)
    to, _ = t_lm.decode_step(tp, torch.from_numpy(nxt), torch.from_numpy(pos),
                             tc, tcfg, tk)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    wc = t_lm.init_caches(tcfg, B, max_len, dtype=torch.float32)
    for i in range(S):
        wl, wc = t_lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                  torch.full((B,), i, dtype=torch.int32),
                                  wc, tcfg, tk)
    return tl, to, wl, wc, torch.from_numpy(nxt), torch.from_numpy(pos)


@pytest.mark.parametrize("arch,variant", [(PHI, "precise"),
                                          (GEMMA, "precise"),
                                          (GEMMA, "int8")])
def test_prefill_handoff_matches_decode_warmup(arch, variant):
    """Logits, rings and the next decode step equal the JAX package's; the
    handed-off rings continue decode as the warmup's do (the JAX test's
    tolerance)."""
    knobs = {"int8": dict(matmul_precision="int8")}.get(variant)
    model = _model(arch)
    tl, to, wl, wc, nxt, pos = _handoff(model, 12, 32, knobs)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), rtol=3e-3, atol=3e-3)
    ow, _ = t_lm.decode_step(model[3], nxt, pos, wc, model[1],
                             ApproxKnobs(**(knobs or {})))
    np.testing.assert_allclose(to.numpy(), ow.numpy(), rtol=3e-3, atol=3e-3)


def test_prefill_window_ring_layout():
    """A local ring (window 8) narrower than the 16-token prompt keeps only
    the last 8 entries, in its first slots with the cursor at 0; decode
    continues through the ring as after the warmup."""
    model = _model(GEMMA, window=8)
    tl, to, wl, wc, nxt, pos = _handoff(model, 16, 48, B=1)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), rtol=3e-3, atol=3e-3)
    ow, _ = t_lm.decode_step(model[3], nxt, pos, wc, model[1])
    np.testing.assert_allclose(to.numpy(), ow.numpy(), rtol=3e-3, atol=3e-3)


def test_jax_prefill_with_cache_needs_a_window_multiple():
    """Reference behaviour: the JAX package's window attention
    (``_banded``) asserts that a sequence longer than the window is a
    multiple of it, so its ``prefill_with_cache`` refuses a 40-token
    prompt at window 32. The port's forward runs windows through
    ``ops.flash``, at any length: its handoff continues decode as the
    warmup's does."""
    jcfg, tcfg, jp, tp = _model(GEMMA)
    with pytest.raises(AssertionError):
        jax_prefill.prefill_with_cache(jp, jnp.ones((1, 40), jnp.int32),
                                       jcfg, 64)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 40)))
    tl, tc = t_prefill.prefill_with_cache(tp, toks, tcfg, 64)
    wc = t_lm.init_caches(tcfg, 1, 64, dtype=torch.float32)
    for i in range(40):
        wl, wc = t_lm.decode_step(tp, toks[:, i:i + 1],
                                  torch.full((1,), i, dtype=torch.int32),
                                  wc, tcfg)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), rtol=3e-3, atol=3e-3)
    nxt, pos = tl.argmax(-1)[:, None], torch.full((1,), 40,
                                                  dtype=torch.int32)
    o1, _ = t_lm.decode_step(tp, nxt, pos, tc, tcfg)
    o2, _ = t_lm.decode_step(tp, nxt, pos, wc, tcfg)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=3e-3, atol=3e-3)


# --------------------------------------------------------- insert_request --

def _dense_fill(cfg, batch, max_len, rng, cursor, quantized=False):
    """``init_caches`` rings in both packages holding the same random
    entries, positions and ``cursor``: (JAX tree, port tree)."""
    out = []
    for c in t_lm.init_caches(cfg, batch, max_len, dtype=torch.float32,
                              quantized=quantized):
        if quantized:
            k, v = (rng.integers(-127, 128, c.k.shape).astype(np.int8)
                    for _ in range(2))
        else:
            k, v = (rng.normal(size=c.k.shape).astype(np.float32)
                    for _ in range(2))
        pos = rng.integers(-1, 64, c.pos.shape).astype(np.int32)
        out.append((k, v, pos, np.full(c.cursor.shape, cursor, np.int32)))
    return (tuple(jax_attn.KVCache(*map(jnp.asarray, a)) for a in out),
            tuple(t_attn.KVCache(*(torch.from_numpy(x.copy()) for x in a))
                  for a in out))


@pytest.mark.parametrize("batched_cursor,single_cursor,quantized",
                         [(37, 11, False), (5, 14, False), (50, 3, True)],
                         ids=["ahead-wraps", "behind", "int8"])
def test_insert_request_matches_jax(batched_cursor, single_cursor,
                                    quantized):
    """Row 1 of a 3-slot tree (gemma2-27b-smoke, max_len 16: local and
    global rings both 16 wide) takes a one-request tree rotated by the
    cursors' difference mod 16; every other row, and the batched cursor,
    stay as they were."""
    tcfg = t_configs.get_config(GEMMA)
    rng = np.random.default_rng(batched_cursor)
    jb, tb = _dense_fill(tcfg, 3, 16, rng, batched_cursor, quantized)
    js, ts = _dense_fill(tcfg, 1, 16, rng, single_cursor, quantized)
    before = caches_to_numpy(tb)
    want = jax_slots.insert_request(jb, js, 1)
    got = t_slots.insert_request(tb, ts, 1)
    assert_caches(got, want, atol=0)
    for b, g, s in zip(before, caches_to_numpy(got), caches_to_numpy(ts)):
        for name in ("k", "v", "pos"):
            x, y = getattr(b, name), getattr(g, name)
            np.testing.assert_array_equal(x[:, [0, 2]], y[:, [0, 2]])
            shift = (batched_cursor - single_cursor) % 16
            np.testing.assert_array_equal(
                y[:, 1], np.roll(getattr(s, name)[:, 0], shift, axis=1))
        np.testing.assert_array_equal(g.cursor, b.cursor)


# --------------------------------------------------------- convert_caches --

def _random_fill(caches, seed):
    """The JAX test's fill: random K/V, a valid position prefix and a
    random cursor per ring; random positions and block tables per pool.
    Returns (JAX tree, port tree) holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for c in caches:
        if isinstance(c, t_attn.KVCache):
            W = c.pos.shape[2]
            n = int(rng.integers(0, W + 1))
            pos = np.full(c.pos.shape, -1, np.int32)
            pos[:, :, :n] = rng.integers(0, 64, pos.shape[:2] + (n,))
            leaves = (rng.standard_normal(c.k.shape),
                      rng.standard_normal(c.v.shape), pos,
                      rng.integers(0, W, c.cursor.shape))
            out.append((jax_attn.KVCache, t_attn.KVCache, leaves))
        else:
            leaves = (rng.standard_normal(c.kp.shape),
                      rng.standard_normal(c.vp.shape),
                      rng.integers(-1, 32, c.ppos.shape),
                      rng.integers(0, c.kp.shape[1], c.block.shape))
            out.append((jax_attn.PagedKVCache, t_attn.PagedKVCache, leaves))
    dts = (np.float32, np.float32, np.int32, np.int32)
    return (tuple(jt(*(jnp.asarray(a.astype(d)) for a, d in zip(lv, dts)))
                  for jt, _, lv in out),
            tuple(tt(*(torch.from_numpy(a.astype(d)) for a, d in
                       zip(lv, dts))) for _, tt, lv in out))


def _check_roundtrip(seed, paged, batch=2, max_len=8):
    """fp32 -> int8 -> fp32 -> int8 in both packages, each tree equal to
    JAX's; int8 -> fp32 -> int8 idempotent, a matching tree unchanged, and
    positions, cursors and block tables carried bit for bit."""
    cfg = t_configs.get_config(PHI)
    if paged:
        shape = t_lm.init_paged_caches(cfg, batch, n_pages=8, page_size=4,
                                       max_pages=2, dtype=torch.float32)
    else:
        shape = t_lm.init_caches(cfg, batch, max_len, dtype=torch.float32)
    j0, t0 = _random_fill(shape, seed)
    jchain, tchain = [j0], [t0]
    for q in (True, False, True):
        jchain.append(jax_slots.convert_caches(jchain[-1], q))
        tchain.append(t_slots.convert_caches(tchain[-1], q))
        assert_caches(tchain[-1], jchain[-1], atol=0)
    _, q1, dq, q2 = tchain

    def kv(cs):
        return [(c[0], c[1]) for c in cs]

    for (k1, v1), (k2, v2) in zip(kv(q1), kv(q2)):
        assert k1.dtype == k2.dtype == torch.int8
        assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert all(a is b for a, b in zip(t_slots.convert_caches(q2, True), q2))
    assert all(a is b for a, b in zip(t_slots.convert_caches(t0, False), t0))
    for chain in (q1, dq, q2):
        for c0, c in zip(t0, chain):
            assert torch.equal(c0[2], c[2]) and torch.equal(c0[3], c[3])


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), paged=st.booleans(),
       batch=st.integers(1, 3))
def test_convert_roundtrip_property(seed, paged, batch):
    _check_roundtrip(seed, paged, batch=batch)


@pytest.mark.parametrize("paged", [False, True])
def test_convert_roundtrip_smoke(paged):
    """Fixed-seed coverage (runs without hypothesis)."""
    _check_roundtrip(seed=0, paged=paged)
