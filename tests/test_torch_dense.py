"""The port's dense ring attention against the JAX package's, on the CPU:
``decode_attention`` (one token a step, the ring smaller than the
sequence, int8 entries), ``chunk_decode_attention`` (a window, int8
entries, a chunk longer than the ring, and the sequence-ring branch under a
4x1 mesh) and ``lm.decode_step`` on ``lm.init_caches`` against the
full-sequence forward.

The same weights (``repro.models.api.init`` and ``init_params``, carried
over through numpy) and the same numpy-seeded inputs go through both
packages. fp32 outputs, logits and K/V agree within 1e-5 (sums in other
orders); int8 K/V, positions and cursors are equal bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import ref as jax_ref
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import lm as jax_lm
from repro_torch import configs as t_configs
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.kernels import ring_attention as t_ring
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as t_attn
from repro_torch.models import lm as t_lm
from repro_torch.models.common import ParamTree

ATOL = 1e-5
ARCH = "phi4-mini-3.8b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, **kw):
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)


def _attn_params(jcfg, seed=0):
    """(JAX dict, port ParamTree) of one attention block's weights."""
    jp = jax_common.init_params(jax_attn.attn_specs(jcfg),
                                jax.random.PRNGKey(seed), jnp.float32)
    return jp, ParamTree({k: torch.tensor(np.asarray(v))
                          for k, v in jp.items()})


def _ring(cfg, B, W, quantized):
    """A fresh ring in both packages (JAX, port)."""
    return (jax_attn.init_cache(cfg[0], B, W, dtype=jnp.float32,
                                quantized=quantized),
            t_attn.init_cache(cfg[1], B, W, dtype=torch.float32,
                              quantized=quantized))


def assert_rings(tcache, jcache):
    """K/V within ATOL (int8 equal), positions and cursor equal."""
    for name, a, b in zip(jax_attn.KVCache._fields, tcache, jcache):
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _decode_run(cfgs, params, x, W, *, window=0, kv_scale=0.0):
    """``decode_attention`` over every position of x (B,S,D) in both
    packages; the per-step outputs compared. Returns (port out, JAX out,
    port ring, JAX ring)."""
    B, S, _ = x.shape
    jc, tc = _ring(cfgs, B, W, kv_scale > 0)
    step = jax.jit(lambda p, x, pos, c: jax_attn.decode_attention(
        p, x, pos, c, cfgs[0], window=window, kv_scale=kv_scale))
    jo, to = [], []
    for t in range(S):
        pos = np.full((B,), t, np.int32)
        o, jc = step(params[0], jnp.asarray(x[:, t:t + 1]),
                     jnp.asarray(pos), jc)
        jo.append(np.asarray(o))
        o, tc = t_attn.decode_attention(
            params[1], torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos), tc, cfgs[1], window=window,
            kv_scale=kv_scale)
        to.append(o.numpy())
    return (np.concatenate(to, 1), np.concatenate(jo, 1), tc, jc)


def test_decode_ring_buffer_window():
    """A 16-entry ring under 48 decode steps (three wraps): every step's
    output and the final ring equal JAX's; the output equals windowed full
    attention (the JAX test's oracle and tolerance)."""
    W = 16
    cfgs = _cfgs(window=W)
    params = _attn_params(cfgs[0])
    x = (np.random.default_rng(5).normal(size=(2, 48, cfgs[1].d_model))
         * 0.3).astype(np.float32)
    got, want, tc, jc = _decode_run(cfgs, params, x, W, window=W)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert_rings(tc, jc)
    assert int(tc.cursor) == 48 and sorted(tc.pos[0].tolist()) == \
        list(range(32, 48))
    cfg, p = cfgs[0], params[0]
    hd = cfg.resolved_head_dim
    q = (x @ np.asarray(p["wq"])).reshape(2, 48, cfg.n_heads, hd)
    k = (x @ np.asarray(p["wk"])).reshape(2, 48, cfg.n_kv_heads, hd)
    v = (x @ np.asarray(p["wv"])).reshape(2, 48, cfg.n_kv_heads, hd)
    pos = jnp.broadcast_to(jnp.arange(48), (2, 48))
    q = jax_common.apply_rope(jnp.asarray(q), pos, cfg.rope_theta)
    k = jax_common.apply_rope(jnp.asarray(k), pos, cfg.rope_theta)
    o = jax_ref.mha_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                        jnp.asarray(v).transpose(0, 2, 1, 3), causal=True,
                        window=W, cap=cfg.attn_softcap)
    oracle = np.asarray(o.transpose(0, 2, 1, 3).reshape(2, 48, cfg.q_dim)
                        @ p["wo"])
    np.testing.assert_allclose(got, oracle, rtol=3e-4, atol=3e-4)


def test_decode_kv_quantization_close():
    """int8 ring entries (kv_scale 0.01) equal JAX's bit for bit, outputs
    within ATOL; the quantised decode stays within 5% of the fp32 one."""
    cfgs = _cfgs()
    params = _attn_params(cfgs[0])
    S = 24
    x = (np.random.default_rng(6).normal(size=(1, S, cfgs[1].d_model))
         * 0.1).astype(np.float32)
    op, _, _, _ = _decode_run(cfgs, params, x, S)
    oq, jq, tc, jc = _decode_run(cfgs, params, x, S, kv_scale=0.01)
    np.testing.assert_allclose(oq, jq, atol=ATOL, rtol=0)
    assert tc.k.dtype == torch.int8
    assert_rings(tc, jc)
    last = slice(S - 1, S)
    rel = np.linalg.norm(oq[:, last] - op[:, last]) / \
        np.linalg.norm(op[:, last])
    assert rel < 0.05, rel


CHUNK_CASES = {
    # name: (window, ring width, chunk lengths, kv_scale)
    "window-wraps": (16, 16, (10, 10, 3), 0.0),
    "kv-scale": (0, 24, (10, 9, 9), 0.05),
    "chunk-over-ring": (8, 8, (20, 7, 1), 0.0),
}


def _chunk_run(cfgs, params, W, chunks, *, window, kv_scale, mesh=None,
               seed=7):
    """Successive ``chunk_decode_attention`` calls on one ring (B 2) in both
    packages, each call's output and the ring after it compared; the port
    runs under ``mesh`` when given, the JAX package on one device."""
    B, D = 2, cfgs[1].d_model
    rng = np.random.default_rng(seed)
    jc, tc = _ring(cfgs, B, W, kv_scale > 0)
    cell = jax.jit(lambda p, x, pos, c: jax_attn.chunk_decode_attention(
        p, x, pos, c, cfgs[0], window=window, kv_scale=kv_scale))
    start = 0
    for C in chunks:
        x = (rng.normal(size=(B, C, D)) * 0.3).astype(np.float32)
        positions = np.broadcast_to(start + np.arange(C, dtype=np.int32),
                                    (B, C)).copy()
        want, jc = cell(params[0], jnp.asarray(x), jnp.asarray(positions),
                        jc)
        got, tc = t_attn.chunk_decode_attention(
            params[1], torch.from_numpy(x), torch.from_numpy(positions), tc,
            cfgs[1], window=window, kv_scale=kv_scale, mesh=mesh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"chunk at {start}")
        assert_rings(tc, jc)
        start += C
    return tc


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_decode_attention_matches_jax(case):
    window, W, chunks, kv_scale = CHUNK_CASES[case]
    cfgs = _cfgs(window=window)
    tc = _chunk_run(cfgs, _attn_params(cfgs[0]), W, chunks, window=window,
                    kv_scale=kv_scale)
    assert int(tc.cursor) == sum(chunks)


def test_chunk_ring_branch_under_a_4x1_mesh():
    """Under a 4x1 mesh the chunks attend through ``ring_chunk_attention``
    over [ring; chunk] (4 sequence shards in turn, ring_hop's plain version
    here): the same outputs and rings as the JAX package's whole-chunk
    path. The 3-token tail is shorter than the 4 shards and takes the
    single-device path."""
    cfgs = _cfgs()
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    t_ring.hops_run = t_ring.hops_skipped = 0
    fallbacks = t_attn.mesh_fallbacks
    _chunk_run(cfgs, _attn_params(cfgs[0]), 32, (8, 12, 3), window=0,
               kv_scale=0.0, mesh=mesh)
    assert t_ring.hops_run + t_ring.hops_skipped == 2 * 4 * 4
    assert t_attn.mesh_fallbacks == fallbacks + 1


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b-smoke", "gemma2-27b-smoke"])
def test_decode_matches_full_forward(arch):
    """16 ``decode_step``s on ``init_caches`` rings: every step's logits
    equal the JAX package's, the rings after the last step too, and the
    last logits equal the full forward's (the JAX test's tolerance)."""
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    B, S = 2, 16
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    jc = jax_lm.init_caches(jcfg, B, S, dtype=jnp.float32)
    tc = t_lm.init_caches(tcfg, B, S, dtype=torch.float32)
    step = jax.jit(lambda p, t, pos, c: jax_lm.decode_step(p, t, pos, c,
                                                           jcfg))
    for i in range(S):
        pos = np.full((B,), i, np.int32)
        want, jc = step(jparams, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                        jnp.asarray(pos), jc)
        got, tc = t_lm.decode_step(tparams, torch.from_numpy(
            toks[:, i:i + 1]), torch.from_numpy(pos), tc, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"step {i}")
    for t, j in zip(tc, jc):
        assert_rings(t, j)
    assert [c.k.shape[2] for c in caches_to_numpy(tc)] == \
        [min(tcfg.window, S) if k == "local" else S for k in tcfg.pattern]
    h, _ = t_lm.forward_hidden(tparams, torch.from_numpy(toks), tcfg,
                               remat="none")
    full = t_lm.logits_fn(tparams, h[:, -1], tcfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=3e-3,
                               atol=3e-3)
