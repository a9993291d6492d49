"""The port's MoE layer against the JAX package's, on the CPU.

``models/moe.py`` (capacity, routing with its tie and drop rules, the
layer on precise and int8 at every ``top_k``), the experts' batched int8
product (``int8_matmul_plain`` and ``ops.quantized_matmul`` on a stack of
experts against ``jax.vmap`` of the JAX references, bit for bit, and the
weight cache on a stacked weight), the ``moe`` subtree through
``convert.py``, ``lm_loss`` on olmoe-1b-7b-smoke, and twins of the JAX
tests ``test_moe_capacity_drops_tokens_but_stays_finite``
(``test_models_smoke.py``), ``test_configs.py::test_moe_knobs`` and
``test_prefill.py``'s olmoe handoff. The same JAX-initialised weights and numpy-seeded inputs go
through both packages in fp32: slots, keep masks and int8 products equal
bit for bit, gates, aux, outputs, logits and K/V within ``ATOL`` (sums in
other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import PRECISE as JAX_PRECISE
from repro.configs.base import MoEConfig as JaxMoE
from repro.kernels import ref as jax_ref
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import PRECISE
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.kernels import int8_matmul as t_i8
from repro_torch.kernels import ops
from repro_torch.models import lm as t_lm
from repro_torch.models import moe as t_moe

from tests.test_torch_prefill import _handoff

ARCH = "olmoe-1b-7b-smoke"
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def model(cf=None):
    """(JAX cfg, port cfg, JAX params, port params) of olmoe-1b-7b-smoke,
    at capacity factor ``cf`` (the config's for None), made once."""
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


def _layer0_moe(cf=None):
    _, tcfg, jp, tp = model(cf)
    jm = jax.tree.map(lambda a: a[0], jp["groups"]["pos0"]["moe"])
    return tcfg, jm, tp.layers[0].moe


@pytest.mark.parametrize("T,k,E,cf", [(1, 2, 8, 1.25), (8, 8, 64, 1.25),
                                      (24, 2, 8, 1.25), (128, 8, 64, 1.25),
                                      (100, 6, 64, 0.25), (2048, 8, 64, 16.0)])
def test_capacity(T, k, E, cf):
    assert t_moe._capacity(T, k, E, cf) == jax_moe._capacity(T, k, E, cf)


def _route_both(x, wg, k, C, E):
    js, jg, jk, ja = jax.jit(lambda a, w: jax_moe._route(a, w, k, C, E))(
        jnp.asarray(x), jnp.asarray(wg))
    ts, tg, tk, ta = t_moe._route(torch.from_numpy(x), torch.from_numpy(wg),
                                  k, C, E)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    return tk.numpy()


@pytest.mark.parametrize("case", ["random", "ties", "tight"])
def test_route_matches_jax(case):
    """Slots, keep mask, gates and aux equal the JAX package's. ``ties``:
    the router's columns are duplicated in threes, so every row's
    probabilities tie in groups and ``top_k`` must take the lower expert
    first, as ``jax.lax.top_k`` does. ``tight``: capacity factor 0.25, and
    some entries are dropped."""
    rng = np.random.default_rng({"random": 0, "ties": 1, "tight": 2}[case])
    T, D, E, k = 40, 16, 12, 4
    x = rng.normal(size=(T, D)).astype(np.float32)
    wg = rng.normal(size=(D, E)).astype(np.float32)
    if case == "ties":
        wg[:, 1::3] = wg[:, 0::3]
        wg[:, 2::3] = wg[:, 0::3]
    cf = 0.25 if case == "tight" else 1.25
    C = t_moe._capacity(T, k, E, cf)
    keep = _route_both(x, wg, k, C, E)
    if case == "tight":
        assert not keep.all()


def test_route_ties_pick_the_lower_expert():
    """A row of five equal largest probabilities: the top 3 are experts 1,
    2, 4 in that order (``jax.lax.top_k``'s), where ``torch.topk`` may pick
    others."""
    p = torch.tensor([[0.0, 1.0, 1.0, 0.5, 1.0, 0.2, 1.0, 1.0]])
    _, ids = t_moe._top_k(p, 3)
    assert ids.tolist() == [[1, 2, 4]]
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(p.numpy()), 3)[1]))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [None, 0.25], ids=["cf1.25", "cf0.25"])
def test_moe_matches_jax(precision, top_k, cf):
    """The layer on layer 0's weights, 3 x 11 tokens, every ``top_k`` of
    the config (2): y and aux within ``ATOL``."""
    tcfg, jm, tm = _layer0_moe(cf)
    jcfg = model(cf)[0]
    x = np.random.default_rng(5).normal(size=(3, 11, tcfg.d_model)) \
        .astype(np.float32)
    jy, ja = jax.jit(lambda p, a: jax_moe.moe(
        p, a, jcfg, top_k=top_k, precision=precision))(jm, jnp.asarray(x))
    ty, ta = t_moe.moe(tm, torch.from_numpy(x), tcfg, top_k=top_k,
                       precision=precision)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=ATOL, rtol=0)


def _stack(E, M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    w = (rng.normal(size=(E, K, N)) / np.sqrt(K)).astype(np.float32)
    w[1, :, 0] = 0.0                       # a zero column: the 1e-8 clamp
    w[2, 3, 1], w[2, K - 1, 1] = 3.0, -3.0  # a tied amax
    tx, tw = (torch.from_numpy(a).to(dtype) for a in (x, w))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return tx, tw, jnp.asarray(tx.float().numpy()).astype(jdt), \
        jnp.asarray(tw.float().numpy()).astype(jdt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("E,M,K,N", [(4, 8, 64, 48), (3, 24, 48, 80),
                                     (5, 1, 32, 16)])
def test_batched_int8_matches_vmap_of_the_jax_refs(E, M, K, N, dtype):
    """``int8_matmul_plain`` / ``int8_matmul_t`` on stacked operands against
    ``jax.vmap`` of ``int8_matmul_ref``, and ``ops.quantized_matmul`` on a
    stack against ``jax.vmap`` of ``quantized_matmul_ref``: bit for bit."""
    tx, tw, jx, jw = _stack(E, M, K, N, dtype, seed=E + M + K)
    jq, js = jax.vmap(jax_ref.quantize_rowwise)(jx)
    wq, ws = jax.vmap(lambda w: jax_ref.quantize_rowwise(w, axis=0))(jw)
    want = jax.vmap(lambda a, b, c, d: jax_ref.int8_matmul_ref(
        a, b, c, d, jnp.float32))(jq, js, wq, ws)
    x_q, x_s = (torch.from_numpy(np.array(a)) for a in (jq, js))
    w_q, w_s = (torch.from_numpy(np.array(a)) for a in (wq, ws))
    got = t_i8.int8_matmul_plain(x_q, x_s, w_q, w_s, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_t = t_i8.int8_matmul_t(x_q, x_s, w_q.transpose(1, 2).contiguous(),
                               w_s.transpose(1, 2).contiguous(),
                               out_dtype=torch.float32)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))
    w_t, w_s2 = ops.quantize_weight(tw)
    np.testing.assert_array_equal(w_t.numpy(),
                                  np.asarray(wq).transpose(0, 2, 1))
    np.testing.assert_array_equal(w_s2.numpy(),
                                  np.asarray(ws).transpose(0, 2, 1))
    ops.clear_weight_cache()
    want_q = jax.vmap(jax_ref.quantized_matmul_ref)(jx, jw)
    got_q = ops.quantized_matmul(tx, tw)
    assert got_q.dtype == dtype and got_q.shape == (E, M, N)
    np.testing.assert_array_equal(got_q.float().numpy(),
                                  np.asarray(want_q.astype(jnp.float32)))


def test_stacked_weight_cache_one_miss_then_hits():
    ops.clear_weight_cache()
    tx, tw, _, _ = _stack(4, 8, 32, 16, torch.float32, seed=3)
    misses = ops.weight_cache_misses
    first = ops.quantized_matmul(tx, tw)
    w_t, w_s = ops.cached_weight(tw)
    for _ in range(3):
        assert torch.equal(ops.quantized_matmul(tx, tw), first)
    assert ops.weight_cache_misses == misses + 1
    assert ops.cached_weight(tw)[0] is w_t and w_t.shape == (4, 16, 32)
    ops.clear_weight_cache()


def test_batched_int8_has_no_backward():
    """The experts' batched product used to raise under autograd; it now
    has a backward (``ops._QuantizedMatmul`` on a stack): the forward
    equals the serving path bit for bit, and the gradients equal, expert
    by expert, those of the 2-D product, zero pattern included.
    ``test_torch_models_smoke.py`` holds them to ``jax.grad`` of the
    vmapped JAX reference."""
    tx, tw, _, _ = _stack(3, 4, 16, 8, torch.float32, seed=4)
    g = torch.randn((3, 4, 8), generator=torch.Generator().manual_seed(4))
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    y = ops.quantized_matmul(x, w)
    with torch.no_grad():
        assert torch.equal(y, ops.quantized_matmul(tx, tw))
    gx, gw = torch.autograd.grad((y * g).sum(), (x, w))
    for e in range(3):
        xe, we = tx[e].clone().requires_grad_(), tw[e].clone().requires_grad_()
        ye = ops.quantized_matmul(xe, we)
        assert torch.equal(ye.detach(), y[e].detach())
        gxe, gwe = torch.autograd.grad((ye * g[e]).sum(), (xe, we))
        for a, b in ((gx[e], gxe), (gw[e], gwe)):
            assert torch.equal(a != 0, b != 0)
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


def test_params_roundtrip_moe_subtree():
    """``params_from_numpy`` carries the ``moe`` subtree of every layer
    (``wg`` (D, E), ``wi_gate`` / ``wi_up`` (E, D, F), ``wo`` (E, F, D))
    and ``tree_to_numpy`` restacks it to the JAX layout unchanged."""
    jcfg, tcfg, jp, tp = model()
    E, D, F = tcfg.moe.n_experts, tcfg.d_model, tcfg.d_ff
    m = tp.layers[1].moe
    assert (m.wg.shape, m.wi_gate.shape, m.wi_up.shape, m.wo.shape) == \
        ((D, E), (E, D, F), (E, D, F), (E, F, D))
    back = tree_to_numpy(dict(tp.named_parameters()), tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert set(back["groups"]["pos0"]["moe"]) == {"wg", "wi_gate", "wi_up",
                                                   "wo"}
    jax.tree.map(np.testing.assert_array_equal, back, want)


@pytest.mark.parametrize("knobs", [{}, dict(topk_override=1)],
                         ids=["precise", "topk1"])
def test_lm_loss_matches_jax(knobs):
    """``lm_loss`` forward on olmoe-1b-7b-smoke: loss, CE and aux (the
    layers' load-balancing losses summed) within ``ATOL``."""
    from repro.approx.knobs import ApproxKnobs as JaxKnobs
    from repro_torch.approx.knobs import ApproxKnobs
    jcfg, tcfg, jp, tp = model()
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 17))
    jl, jmet = jax.jit(lambda p, t: jax_api.loss_fn(jcfg)(
        p, {"tokens": t}, knobs=JaxKnobs(**knobs), remat="none"))(
        jp, jnp.asarray(toks))
    tl, tmet = t_lm.lm_loss(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                            ApproxKnobs(**knobs), remat="none")
    for a, b in ((tl, jl), (tmet["ce"], jmet["ce"]),
                 (tmet["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(a), float(b), atol=ATOL, rtol=0)
    assert float(tmet["aux"]) > 0


def test_moe_capacity_drops_tokens_but_stays_finite():
    """Twin of the JAX test: capacity factor 0.25 drops entries, and the
    loss stays finite (and equals the JAX package's)."""
    jcfg, tcfg, jp, tp = model(0.25)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 33))
    tl, _ = t_lm.lm_loss(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                         PRECISE, remat="none")
    jl, _ = jax.jit(lambda p, t: jax_api.loss_fn(jcfg)(
        p, {"tokens": t}, knobs=JAX_PRECISE, remat="none"))(
        jp, jnp.asarray(toks))
    assert torch.isfinite(tl)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL, rtol=0)
    x = tp.embed[torch.from_numpy(toks[:, :-1])].reshape(-1, tcfg.d_model)
    C = t_moe._capacity(x.shape[0], 2, 8, 0.25)
    assert not t_moe._route(x, tp.layers[0].moe.wg, 2, C, 8)[2].all()


def test_moe_knobs():
    """Twin of ``tests/test_configs.py::test_moe_knobs``."""
    archs = t_configs.ARCHS
    assert archs["olmoe-1b-7b"].moe.n_experts == 64
    assert archs["olmoe-1b-7b"].moe.top_k == 8
    assert archs["moonshot-v1-16b-a3b"].moe.top_k == 6


def test_prefill_handoff_matches_decode_warmup():
    """Twin of ``tests/test_prefill.py``'s olmoe case, at capacity factor
    16 as there (routing all 12 tokens at once drops no other entries than
    one token a step does): logits, rings and the next decode step equal
    the JAX package's within 1e-5, and the handed-off rings continue decode
    as the port's token-by-token warmup's do (the JAX test's tolerance)."""
    m = model(16.0)
    tl, to, wl, wc, nxt, pos = _handoff(m, 12, 32)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), rtol=3e-3, atol=3e-3)
    ow, _ = t_lm.decode_step(m[3], nxt, pos, wc, m[1])
    np.testing.assert_allclose(to.numpy(), ow.numpy(), rtol=3e-3, atol=3e-3)

