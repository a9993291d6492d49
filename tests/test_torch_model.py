"""The port's model modules against the JAX package on phi4-mini-3.8b-smoke,
on the CPU: the same fp32 weights (``repro.models.api.init``, converted with
``repro_torch.convert``) and the same numpy-seeded inputs go through both.
Tolerances are for fp32 sums taken in other orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import lm as jax_lm
from repro.models import mlp as jax_mlp
from repro.serve import prefill as jax_prefill
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.convert import caches_to_numpy, params_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.models import mlp as t_mlp
from repro_torch.serve import prefill as t_prefill

ARCH = "phi4-mini-3.8b-smoke"
P, M = 4, 6
KNOBS = {"precise": dict(),
         "int8": dict(matmul_precision="int8"),
         "int8+kvq8": dict(matmul_precision="int8", kv_quant=True)}


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_and_param_count(model):
    jcfg, tcfg, jparams, tparams = model
    assert tcfg == t_configs.get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "rope_theta", "norm_eps"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    full = t_configs.get_config("phi4-mini-3.8b")
    assert full.param_count() == jax_configs.get_config(
        "phi4-mini-3.8b").param_count()
    assert sum(p.numel() for p in tparams.parameters()) == \
        tcfg.param_count()


@pytest.mark.parametrize("arch", sorted(t_configs.ARCHS))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_configs_equal_jax(arch, smoke):
    """Every config the port registers equals the JAX package's field for
    field (MoE and SSM sub-configs included), and both packages agree on
    ``SHAPES`` and ``shape_applicable``."""
    import dataclasses
    from repro.configs.base import SHAPES as JAX_SHAPES
    from repro.configs.base import shape_applicable as jax_applicable
    from repro_torch.configs.base import SHAPES, shape_applicable
    name = arch + "-smoke" if smoke else arch
    tcfg, jcfg = t_configs.get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    for k in SHAPES:
        assert shape_applicable(tcfg, SHAPES[k]) == \
            jax_applicable(jcfg, JAX_SHAPES[k])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b-smoke", "olmoe-1b-7b"])
def test_init_lm_refuses_experts(arch):
    """The port has no MoE block: a config with experts raises rather than
    building a dense model in its place."""
    cfg = t_configs.get_config(arch)
    assert cfg.moe is not None
    with pytest.raises(NotImplementedError, match="MoE"):
        t_lm.init_lm(cfg, 0, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        t_lm.lm_specs(cfg)


def test_rms_norm(model):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = t_common.rms_norm(_t(x), _t(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_apply_rope():
    """Angles up to ~4000 rad: sin/cos of the two libraries agree to an
    ulp of the result (atol 1e-5 on |x| ~ 3)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = t_common.apply_rope(_t(x), _t(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_mlp(model, precision):
    """int8: gate and up are exact W8A8 products; silu may differ by an ulp,
    which can move the down projection's input quantization by one step on
    an entry exactly at .5 (atol 1e-4 covers one step)."""
    jcfg, tcfg, jparams, tparams = model
    x = np.random.default_rng(2).normal(size=(2, 3, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["pos0"]["mlp"])
    want = jax_mlp.mlp(jp, jnp.asarray(x), precision=precision)
    got = t_mlp.mlp(tparams.layers[0].mlp, _t(x), precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


def _paged_state(cfg, lengths, *, quantized, seed=0):
    rng = np.random.default_rng(seed)
    B, G, hd = len(lengths), cfg.n_kv_heads, cfg.resolved_head_dim
    n_pages = 1 + B * M
    kp = (rng.normal(size=(n_pages, P, G, hd)) * 0.3).astype(np.float32)
    vp = rng.normal(size=(n_pages, P, G, hd)).astype(np.float32)
    if quantized:
        kp = np.clip(np.round(kp / 0.05), -127, 127).astype(np.int8)
        vp = np.clip(np.round(vp / 0.05), -127, 127).astype(np.int8)
    block = np.zeros((B, M), np.int32)
    ppos = np.full((n_pages, P), -1, np.int32)
    pid = 1
    for b, L in enumerate(lengths):
        for lp in range(-(-(L + 1) // P)):
            block[b, lp] = pid
            top = min(L, (lp + 1) * P)
            ppos[pid, : max(top - lp * P, 0)] = np.arange(lp * P, top)
            pid += 1
    x = (rng.normal(size=(B, 1, cfg.d_model)) * 0.3).astype(np.float32)
    return x, np.asarray(lengths, np.int32), (kp, vp, ppos, block)


def _assert_caches(tc, jc, *, kv_atol=1e-5):
    """Leaves equal (K/V to fp32 rounding; int8 K/V exactly), the null page
    0 excepted: inactive rows park their writes there and nothing reads
    it."""
    for name, a, b in zip(("kp", "vp", "ppos", "block"), tc, jc):
        a, b = np.asarray(a), np.asarray(b)
        if name in ("kp", "vp"):
            a, b = a[..., 1:, :, :, :], b[..., 1:, :, :, :]
            if a.dtype == np.int8:
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, atol=kv_atol, rtol=0,
                                           err_msg=name)
        else:
            if name == "ppos":
                a, b = a[..., 1:, :], b[..., 1:, :]
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_attention(model, quantized):
    """Output on every row against the Pallas kernel in interpret mode (the
    row with active=False included), and the written cache."""
    jcfg, tcfg, jparams, tparams = model
    x, pos, (kp, vp, ppos, block) = _paged_state(tcfg, [0, 5, 9, 14],
                                                 quantized=quantized)
    active = np.array([True, True, False, True])
    kv_scale = 0.05 if quantized else 0.0
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["pos0"]["attn"])
    jcache = jax_attn.PagedKVCache(*map(jnp.asarray, (kp, vp, ppos, block)))
    want, jnew = jax_attn.paged_decode_attention(
        jp, jnp.asarray(x), jnp.asarray(pos), jcache, jcfg,
        kv_scale=kv_scale, active=jnp.asarray(active), use_kernel=True,
        interpret=True, dyn_scatter=True)
    tcache = t_attn.PagedKVCache(*map(lambda a: _t(a.copy()),
                                      (kp, vp, ppos, block)))
    got, tnew = t_attn.paged_decode_attention(
        tparams.layers[0].attn, _t(x), _t(pos), tcache, tcfg,
        kv_scale=kv_scale, active=_t(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _assert_caches([t.numpy() for t in tnew], jnew)
    # the inactive row's tail page was not written
    tail = block[2, 9 // P]
    assert (tnew.ppos[tail].numpy() == ppos[tail]).all()


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_chunk_attention(model, quantized):
    jcfg, tcfg, jparams, tparams = model
    _, _, (kp, vp, ppos, block) = _paged_state(tcfg, [3, 9, 14],
                                               quantized=quantized)
    rng = np.random.default_rng(5)
    C, start = 5, 10                      # slot 1: positions 10..14
    x = (rng.normal(size=(1, C, tcfg.d_model)) * 0.3).astype(np.float32)
    positions = (start + np.arange(C, dtype=np.int32))[None]
    block[1, :4] = block[2, :4]           # slot 1 maps 4 pages (0..15)
    kv_scale = 0.05 if quantized else 0.0
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["pos0"]["attn"])
    jcache = jax_attn.PagedKVCache(*map(jnp.asarray, (kp, vp, ppos, block)))
    want, jnew = jax_attn.paged_chunk_attention(
        jp, jnp.asarray(x), jnp.asarray(positions), jcache, jcfg,
        jnp.int32(1), kv_scale=kv_scale, dyn_scatter=True)
    tcache = t_attn.PagedKVCache(*map(lambda a: _t(a.copy()),
                                      (kp, vp, ppos, block)))
    got, tnew = t_attn.paged_chunk_attention(
        tparams.layers[0].attn, _t(x), _t(positions), tcache, tcfg, 1,
        kv_scale=kv_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _assert_caches([t.numpy() for t in tnew], jnew)


@pytest.mark.parametrize("variant", list(KNOBS))
def test_prefill_and_decode_step(model, variant):
    """Two slots prefilled in chunks through ``paged_prefill_chunk``, then
    two ``decode_step``s (the second with slot 1 inactive): logits allclose
    at every call, caches equal after ``caches_to_numpy`` (int8 K/V
    exactly), and the inactive row's pages frozen bit for bit."""
    jcfg, tcfg, jparams, tparams = model
    jk, tk = JaxKnobs(**KNOBS[variant]), ApproxKnobs(**KNOBS[variant])
    B, n_pages, max_pages = 2, 16, 8
    jc = jax_lm.init_paged_caches(jcfg, B, n_pages, P, max_pages,
                                  dtype=jnp.float32, quantized=jk.kv_quant)
    tc = t_lm.init_paged_caches(tcfg, B, n_pages, P, max_pages,
                                dtype=torch.float32, quantized=tk.kv_quant)
    block = np.zeros((B, max_pages), np.int32)
    block[0, :4] = [3, 7, 1, 9]
    block[1, :3] = [2, 5, 11]
    jc = tuple(c._replace(block=jnp.broadcast_to(jnp.asarray(block),
                                                 c.block.shape)) for c in jc)
    for c in tc:
        c.block.copy_(torch.from_numpy(block).expand_as(c.block))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tcfg.vocab_size, 9), rng.integers(
        1, tcfg.vocab_size, 6)]
    for slot, prompt in enumerate(prompts):
        for start in range(0, len(prompt), 5):
            toks = prompt[None, start:start + 5].astype(np.int32)
            jl, jc = jax_prefill.paged_prefill_chunk(
                jparams, jnp.asarray(toks), jnp.int32(start), jc,
                jnp.int32(slot), jcfg, jk, dyn_scatter=True)
            tl, tc = t_prefill.paged_prefill_chunk(
                tparams, _t(toks).long(), start, tc, slot, tcfg, tk)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
    pos = np.array([9, 6], np.int32)
    for active in ([True, True], [True, False]):
        toks = rng.integers(1, tcfg.vocab_size, (B, 1)).astype(np.int32)
        act = np.array(active)
        before = caches_to_numpy(tc)
        jl, jc = jax_lm.decode_step(jparams, jnp.asarray(toks),
                                    jnp.asarray(pos), jc, jcfg, jk,
                                    active=jnp.asarray(act),
                                    dyn_scatter=True)
        tl, tc = t_lm.decode_step(tparams, _t(toks).long(), _t(pos), tc,
                                  tcfg, tk, active=_t(act))
        np.testing.assert_allclose(tl[act].numpy(), np.asarray(jl)[act],
                                   atol=1e-4, rtol=1e-4)
        after = caches_to_numpy(tc)
        for c_t, c_j in zip(after, jc):
            _assert_caches(c_t, c_j)
        if not active[1]:                 # FREEZE: slot 1's pages untouched
            pages = block[1][block[1] != 0]
            for b0, a0 in zip(before, after):
                for leaf in ("kp", "vp", "ppos"):
                    np.testing.assert_array_equal(
                        getattr(a0, leaf)[:, pages],
                        getattr(b0, leaf)[:, pages])
        pos = pos + act
