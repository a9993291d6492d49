"""The port's vlm path (``lm.forward_hidden`` with ``prefix_embeds``,
``lm_loss`` with the prefix cut off the loss and cut with the tokens under
``token_drop``, ``make_prefill_fn`` and ``make_serve_step``'s decoder
branch) against the JAX package on paligemma-3b-smoke, on the CPU: the
same fp32 weights (``repro.models.api.init`` converted through numpy) and
the same numpy-seeded tokens and patch embeddings go through both.

Tolerances: fp32 sums taken in other orders. Hidden states, logits and
precise losses within 1e-5 of the largest entry; int8 losses within 1e-4;
gradients within 1e-4 of each leaf's largest entry, on int8 with their
zero pattern equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.models import lm as jax_lm
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import lm as t_lm
from repro_torch.train import step as t_step

ARCH = "paligemma-3b-smoke"
B, S = 4, 16
VAL_REL, INT8_REL, GRAD_REL = 1e-5, 1e-4, 1e-4
RUNGS = {"precise": dict(), "int8": dict(matmul_precision="int8"),
         "int8+drop50%": dict(matmul_precision="int8", token_drop=0.5),
         "drop50%": dict(token_drop=0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    prefix = rng.normal(size=(B, tcfg.n_prefix_tokens, tcfg.d_model)
                        ).astype(np.float32)
    return jcfg, tcfg, jparams, np_tree, tokens, prefix


def _close_rel(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_forward_hidden_with_prefix_matches_jax(model):
    """The prefix is prepended (positions run over P + S) and the hidden
    states of every position equal the JAX package's."""
    jcfg, tcfg, jparams, np_tree, tokens, prefix = model
    want, _ = jax.jit(lambda p, t, e: jax_lm.forward_hidden(
        p, t, jcfg, prefix_embeds=e, remat="none"))(
        jparams, jnp.asarray(tokens[:, :-1]), jnp.asarray(prefix))
    got, _ = t_lm.forward_hidden(
        params_from_numpy(np_tree, tcfg), torch.from_numpy(tokens[:, :-1]),
        tcfg, prefix_embeds=torch.from_numpy(prefix), remat="full")
    assert got.shape == (B, tcfg.n_prefix_tokens + S, tcfg.d_model)
    _close_rel(got.detach().numpy(), want, VAL_REL)


@pytest.mark.parametrize("rung", list(RUNGS))
def test_lm_loss_with_prefix_and_grads_match_jax(model, rung):
    """``lm_loss`` on a vlm batch: the prefix is cut to the kept rows under
    ``token_drop`` and sliced off before the loss; loss and gradients
    against ``jax.value_and_grad``."""
    jcfg, tcfg, jparams, np_tree, tokens, prefix = model
    batch = {"tokens": jnp.asarray(tokens),
             "prefix_embeds": jnp.asarray(prefix)}

    def jloss(p):
        return jax_lm.lm_loss(p, batch, jcfg, JaxKnobs(**RUNGS[rung]),
                              remat="none")[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tp = params_from_numpy(np_tree, tcfg).requires_grad_(True)
    named = dict(tp.named_parameters())
    tl, _ = t_lm.lm_loss(tp, {"tokens": torch.from_numpy(tokens),
                              "prefix_embeds": torch.from_numpy(prefix)},
                         tcfg, ApproxKnobs(**RUNGS[rung]), remat="full")
    int8 = RUNGS[rung].get("matmul_precision") == "int8"
    _close_rel(float(tl.detach()), float(jl), INT8_REL if int8 else VAL_REL,
               "loss")
    grads = torch.autograd.grad(tl, list(named.values()))
    got = _flat(tree_to_numpy(dict(zip(named, grads)), tcfg))
    want = _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k in want:
        _close_rel(got[k], want[k], GRAD_REL, k)
        if int8:
            assert np.array_equal(got[k] != 0, want[k] != 0), k


def test_make_prefill_fn_with_prefix_matches_jax(model):
    jcfg, tcfg, jparams, np_tree, tokens, prefix = model
    want = jax.jit(jax_step.make_prefill_fn(jcfg, remat="none"))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "prefix_embeds": jnp.asarray(prefix)})
    got = t_step.make_prefill_fn(tcfg)(
        params_from_numpy(np_tree, tcfg),
        {"tokens": torch.from_numpy(tokens),
         "prefix_embeds": torch.from_numpy(prefix)})
    assert got.shape == (B, tcfg.vocab_size)
    _close_rel(got.numpy(), want, VAL_REL)


def test_make_serve_step_decoder_branch_matches_jax(model):
    """``make_serve_step``'s decoder branch on dense rings, four steps."""
    jcfg, tcfg, jparams, np_tree, tokens, _ = model
    tp = params_from_numpy(np_tree, tcfg)
    jfn = jax.jit(jax_step.make_serve_step(jcfg))
    tfn = t_step.make_serve_step(tcfg)
    jc = jax_lm.init_caches(jcfg, B, 8, dtype=jnp.float32)
    tc = t_lm.init_caches(tcfg, B, 8, dtype=torch.float32)
    for i in range(4):
        pos = np.full((B,), i, np.int32)
        want, jc = jfn(jparams, jnp.asarray(tokens[:, i:i + 1]),
                       jnp.asarray(pos), jc)
        got, tc = tfn(tp, torch.from_numpy(tokens[:, i:i + 1]),
                      torch.from_numpy(pos), tc)
        _close_rel(got.numpy(), want, VAL_REL, f"step {i}")
