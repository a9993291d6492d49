"""The rest of the twin of ``tests/test_models_smoke.py`` (its train step
on every arch, the remat policies and the capacity drop are in
``tests/test_torch_models_smoke.py``, whose weights, batches and
tolerances this file shares): the approximate training rungs, decode
against the full forward, micro-batches that split every leaf of the
batch, and the experts' stacked int8 product's backward against
``jax.grad`` of the vmapped JAX reference, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import lm as jax_lm
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import lm as t_lm
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step
from tests.test_torch_models_smoke import (INT8_REL, VAL_REL, _batch,
                                           _params_np, _rel, _steps, model)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["gemma3-12b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b"])
def test_approx_variant_step(name):
    """int8 + ``token_drop`` 0.5 + ``layer_skip`` 0.5 (+ ``topk_override``
    1 with experts, whose int8 products go through the stacked backward):
    the loss equals the JAX step's and is finite."""
    cfg = model(name)[1]
    knobs = dict(matmul_precision="int8", token_drop=0.5, layer_skip=0.5,
                 topk_override=1 if cfg.moe else 0)
    (_, _, jm), (_, _, tm) = _steps(name, knobs)
    assert np.isfinite(float(tm["loss"]))
    _rel(tm["loss"], jm["loss"], INT8_REL, "loss")


@pytest.mark.parametrize("name", ["gemma3-12b", "zamba2-2.7b"])
def test_decode_matches_full_forward(name):
    """16 ``decode_step``s on ``init_caches`` rings: every step's logits
    equal the JAX step's, and the last the full forward's (the JAX test's
    3e-3). whisper's twin is in ``test_torch_encdec.py``."""
    jcfg, tcfg, jp, np_tree = model(name)
    tp = params_from_numpy(np_tree, tcfg)
    B, S = 2, 16
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S))
    jc = jax_lm.init_caches(jcfg, B, S, dtype=jnp.float32)
    tc = t_lm.init_caches(tcfg, B, S, dtype=torch.float32)
    step = jax.jit(lambda p, t, pos, c: jax_lm.decode_step(p, t, pos, c,
                                                           jcfg))
    for i in range(S):
        pos = np.full((B,), i, np.int32)
        want, jc = step(jp, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                        jnp.asarray(pos), jc)
        got, tc = t_lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                   torch.from_numpy(pos), tc, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=VAL_REL * float(np.abs(want).max()),
                                   err_msg=f"step {i}")
    h, _ = t_lm.forward_hidden(tp, torch.from_numpy(toks), tcfg,
                               remat="none")
    full = t_lm.logits_fn(tp, h[:, -1], tcfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=3e-3,
                               atol=3e-3)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "whisper-large-v3",
                                  "paligemma-3b"])
def test_microbatch_equals_full_batch_grads(name):
    """Two micro-batches (every leaf of the batch split: ``frames`` and
    ``prefix_embeds`` too) against the whole batch: the loss within 1e-5
    and the parameters as the JAX test holds them; the micro-batched loss
    equals the JAX micro-batched step's."""
    tcfg = model(name)[1]
    _, tb = _batch(tcfg, B=4)
    _, _, _, np_tree = model(name)
    out = []
    for n_micro in (1, 2):
        tp = params_from_numpy(np_tree, tcfg)
        step = t_step.make_train_step(tcfg, remat="none", n_micro=n_micro)
        out.append(step(tp, t_optim.init_opt(tp), tb))
    (p1, _, m1), (p2, _, m2) = out
    _rel(m1["loss"], m2["loss"], VAL_REL, "loss")
    for a, b in zip(_params_np(p1, tcfg), _params_np(p2, tcfg)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    (_, _, jm), (_, _, tm) = _steps(name, {}, B=4, n_micro=2)
    _rel(tm["loss"], jm["loss"], VAL_REL, "JAX micro-batched loss")


@pytest.mark.parametrize("E,M,K,N", [(4, 8, 64, 48), (3, 24, 48, 80)])
def test_stacked_int8_grads_match_jax_grad_of_vmap(E, M, K, N):
    """``ops.quantized_matmul`` on a stack of experts under autograd
    (``_QuantizedMatmul`` on a stack): the forward bit for bit and the gradients of x and
    w against ``jax.grad`` of ``jax.vmap(quantized_matmul_ref)``, their
    zero pattern equal (only each row's and column's arg-max entry is
    reached) and within 1e-5 of their largest entry."""
    rng = np.random.default_rng(E * M)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    w = (rng.normal(size=(E, K, N)) / np.sqrt(K)).astype(np.float32)
    w[1, :, 0] = 0.0                        # a zero column: the 1e-8 clamp
    w[2, 3, 1], w[2, K - 1, 1] = 3.0, -3.0  # a tied amax
    g = rng.normal(size=(E, M, N)).astype(np.float32)

    def f(a, b):
        return jnp.sum(jax.vmap(jax_ref.quantized_matmul_ref)(a, b) * g)
    jy = jax.vmap(jax_ref.quantized_matmul_ref)(x, w)
    jgx, jgw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = ops.quantized_matmul(tx, tw)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    tgx, tgw = torch.autograd.grad((ty * torch.from_numpy(g)).sum(),
                                   (tx, tw))
    for got, want in ((tgx, jgx), (tgw, jgw)):
        want = np.asarray(want)
        assert np.array_equal(got.numpy() != 0, want != 0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    assert 0 < np.count_nonzero(tgw.numpy()) <= E * N * 2
