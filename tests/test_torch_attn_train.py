"""The port's dense-attention training path against the JAX package on the
CPU: ``models.attention.attention`` in every mode, then ``lm_loss``, its
gradients and AdamW steps on phi4-mini-3.8b-smoke, on each rung of the
training ladder. The same fp32 weights (``repro.models.api.init``,
converted through numpy with ``repro_torch.convert``) and the same numpy
inputs go through both; the port's gradients are restacked into the JAX
layout (``convert.tree_to_numpy``) and compared leaf by leaf.

On the CPU the port's attention takes ``flash_attention``'s plain version
(the CUDA kernel's function) in the causal, window, full and cross modes,
and the JAX package's absolute chunk perforation in plain PyTorch at
``kv_keep_stride`` > 1; the JAX package runs ``_causal_chunked``,
``_banded`` and ``_sdpa``.

Tolerances: fp32 sums in other orders. Values within 1e-5 of the largest
|value|, gradients within 1e-4 of each leaf's largest entry, parameters
after three AdamW steps within 1e-5 absolute (1% of one step at lr 1e-3).
The int8 rungs pass gradient only through the quantisation scales (ROADMAP
queue 3), so their gradients' zero patterns must be equal, not close. They
are also discontinuous: ``round(x / scale)`` of an MLP input that lies
within an ulp of a rounding boundary flips by one code when the two
packages' fp32 activations differ in the last bit, and the gradient then
moves by about one code in 127. At this batch the JAX package's own int8
gradient moves by 0.45% of each leaf's largest entry when its weights are
scaled by 1 + 1e-7 noise; so on the int8 rungs gradients are held to 1e-2
of each leaf's largest entry, losses after a step to 1e-4 relative, and
parameters after three steps to 2e-4 absolute (a fifth of one step: Adam
normalises each entry's step, so an entry with a near-zero gradient moves
by up to a step either way)."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import lm as jax_lm
from repro.train import optim as jax_optim
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import lm as t_lm
from repro_torch.models.common import ParamTree
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

ARCH = "phi4-mini-3.8b-smoke"
B, S = 4, 32
# the explorer's training ladder for phi4-mini (test_torch_train holds it)
RUNGS = [dict(), dict(matmul_precision="int8"),
         dict(matmul_precision="int8", kv_keep_stride=2),
         dict(matmul_precision="int8", token_drop=0.5)]
RUNG_IDS = ["precise", "int8", "int8+kvstride2", "int8+drop50%"]
VAL_REL, GRAD_REL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
INT8_GRAD_REL, INT8_LOSS_REL, INT8_PARAM_ATOL = 1e-2, 1e-4, 2e-4


def _close_rel(got, want, rel, what):
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


# ------------------------------------------------------------- attention --

def _attn_case(seed, window=16, cap=0.0):
    jcfg = dataclasses.replace(jax_configs.get_config(ARCH), window=window,
                               attn_softcap=cap)
    tcfg = dataclasses.replace(t_configs.get_config(ARCH), window=window,
                               attn_softcap=cap)
    rng = np.random.default_rng(seed)
    d, qd, kvd = jcfg.d_model, jcfg.q_dim, jcfg.kv_dim
    w = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d)}
    w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in w.items()}
    return jcfg, tcfg, w, rng


def _attn_both(jcfg, tcfg, w, x, kv_x, g, **kw):
    """Output and gradients (weights, x, kv_x) of ``sum(attention * g)``
    from both packages."""
    Bx, Sx = x.shape[:2]
    pos = np.broadcast_to(np.arange(Sx), (Bx, Sx)).astype(np.int32)

    def jf(p, a, c):
        out = jax_attn.attention(p, a, jnp.asarray(pos), jcfg, kv_x=c, **kw)
        return jnp.sum(out * g), out
    jargs = ({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
             None if kv_x is None else jnp.asarray(kv_x))
    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                       has_aux=True)(*jargs)
    tp = ParamTree({k: torch.tensor(v) for k, v in w.items()})
    tp.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    tkv = None if kv_x is None else torch.tensor(kv_x, requires_grad=True)
    tout = t_attn.attention(tp, tx, torch.tensor(pos).long(), tcfg, kv_x=tkv,
                            **kw)
    ins = [tp.wq, tp.wk, tp.wv, tp.wo, tx] + ([] if tkv is None else [tkv])
    tg = torch.autograd.grad((tout * torch.tensor(g)).sum(), ins)
    want = [jg[0][k] for k in ("wq", "wk", "wv", "wo")] + [jg[1]] + \
        ([] if kv_x is None else [jg[2]])
    return tout.detach().numpy(), np.asarray(jout), tg, want


@pytest.mark.parametrize("mode,cap", [("causal", 0.0), ("window", 0.0),
                                      ("window", 20.0), ("full", 0.0),
                                      ("cross", 0.0)],
                         ids=["causal", "window", "window+cap", "full",
                              "cross"])
def test_attention_matches_jax(mode, cap):
    """Forward and gradients, mode by mode, at B 2, S 64, window 16 (the
    port through ``ops.flash``, the JAX package through ``_causal_chunked``,
    ``_banded`` or ``_sdpa``); ``cross`` attends over 24 other tokens."""
    jcfg, tcfg, w, rng = _attn_case(0, cap=cap)
    x = rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32)
    kv_x = (rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
            if mode == "cross" else None)
    g = rng.normal(size=x.shape).astype(np.float32)
    got, want, tg, jg = _attn_both(jcfg, tcfg, w, x, kv_x, g, mode=mode)
    _close_rel(got, want, VAL_REL, "out")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close_rel(a.numpy(), b, GRAD_REL, f"grad {i}")


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_causal_chunked_perforation_matches_jax(stride):
    """q_chunk 16 over S 64 (four chunks): at strides 2 and 4 chunk 3 keeps
    chunks 0, 2 and 3 and drops chunk 1 (the JAX package's absolute rule,
    in both packages), chunks 0-2 keep everything. Stride 1 goes through
    ``ops.flash``."""
    jcfg, tcfg, w, rng = _attn_case(1)
    x = rng.normal(size=(2, 64, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    got, want, tg, jg = _attn_both(jcfg, tcfg, w, x, None, g, mode="causal",
                                   q_chunk=16, kv_keep_stride=stride)
    _close_rel(got, want, VAL_REL, "out")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close_rel(a.numpy(), b, GRAD_REL, f"grad {i}")
    if stride > 1:
        precise, _, _, _ = _attn_both(jcfg, tcfg, w, x, None, g,
                                      mode="causal", q_chunk=16)
        assert np.abs(got - precise)[:, :32].max() < 1e-6
        assert np.abs(got - precise)[:, 48:].max() > 1e-3


def test_kernel_rule_is_not_the_model_rule():
    """The kernel's ``kv_keep_stride`` rule is relative to the query block
    (block (3, 1) of a 16-grid is "near" and runs, block (3, 0) is skipped),
    the model's is absolute (chunk 3 keeps chunk 0 and drops chunk 1): on
    the same q, k, v the two give different rows 48..63."""
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.normal(size=(1, 64, 2, 2, 16)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(1, 64, 2, 16)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(1, 64, 2, 16)), dtype=torch.float32)
    model = t_attn._causal_chunked(q, k, v, q_chunk=16, kv_keep_stride=2,
                                   cap=0.0).reshape(1, 64, 4, 16)
    kern = fa.flash_attention_plain(
        q.reshape(1, 64, 4, 16).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), kv_keep_stride=2, bq=16, bk=16).transpose(1, 2)
    assert (model - kern)[:, :48].abs().max() < 1e-6
    assert (model - kern)[:, 48:].abs().max() > 1e-2


def test_default_q_chunk_matches_jax():
    for s in (32, 1024, 4096, 8192, 8193, 32768):
        assert t_attn.default_q_chunk(s) == jax_attn.default_q_chunk(s)


# ------------------------------------------------------------------ model --

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_tree = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return jcfg, tcfg, jparams, np_tree, tokens


def _tparams(tcfg, np_tree):
    return convert.params_from_numpy(np_tree, tcfg).requires_grad_(True)


def test_param_tree_round_trip(setup):
    """phi4-mini's training tree goes to the port's per-layer blocks and
    back to the JAX layout unchanged (every leaf, both layers)."""
    _, tcfg, _, np_tree, _ = setup
    tp = convert.params_from_numpy(np_tree, tcfg)
    assert len(tp.layers) == tcfg.n_layers == 2
    got = _flat(convert.tree_to_numpy(dict(tp.named_parameters()), tcfg))
    want = _flat(np_tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("rung", RUNGS, ids=RUNG_IDS)
def test_lm_loss_and_grads_match_jax(setup, rung):
    """``lm_loss`` and its whole gradient tree against
    ``jax.value_and_grad`` on each rung (the port under ``remat="full"``,
    the JAX package without remat)."""
    jcfg, tcfg, jparams, np_tree, tokens = setup

    def jloss(p):
        return jax_lm.lm_loss(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                              JaxKnobs(**rung), remat="none")[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tp = _tparams(tcfg, np_tree)
    named = dict(tp.named_parameters())
    tl, _ = t_lm.lm_loss(tp, {"tokens": torch.tensor(tokens)}, tcfg,
                         ApproxKnobs(**rung), remat="full")
    grads = torch.autograd.grad(tl, list(named.values()))
    _close_rel(float(tl.detach()), float(jl), VAL_REL, "loss")
    got = _flat(convert.tree_to_numpy(dict(zip(named, grads)), tcfg))
    want = _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k in want:
        _close_rel(got[k], want[k], INT8_GRAD_REL if rung else GRAD_REL, k)
        if rung:                     # int8: the scales carry the gradient
            assert np.array_equal(got[k] != 0, want[k] != 0), k


def test_lm_loss_perforated_at_4096_tokens_matches_jax():
    """At 2 x 4096 tokens the default query chunk (1024) makes four chunks,
    so ``kv_keep_stride`` 2 really drops chunk 1 for chunk 3 (the smallest
    shape where the four rungs differ). The perforation alone (matmuls
    unquantised, so the comparison stays continuous): loss and gradients
    equal the JAX package's, and the loss differs from stride 1's."""
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(1), jnp.float32)
    np_tree = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 4097)).astype(np.int32)
    losses = {}
    for rung in (dict(), dict(kv_keep_stride=2)):
        def jloss(p):
            return jax_lm.lm_loss(p, {"tokens": jnp.asarray(tokens)}, jcfg,
                                  JaxKnobs(**rung), remat="none")[0]
        jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
        tp = _tparams(tcfg, np_tree)
        named = dict(tp.named_parameters())
        tl, _ = t_lm.lm_loss(tp, {"tokens": torch.tensor(tokens)}, tcfg,
                             ApproxKnobs(**rung), remat="full")
        grads = torch.autograd.grad(tl, list(named.values()))
        _close_rel(float(tl.detach()), float(jl), VAL_REL, "loss")
        got = _flat(convert.tree_to_numpy(dict(zip(named, grads)), tcfg))
        want = _flat(jax.tree.map(np.asarray, jg))
        for k in want:
            _close_rel(got[k], want[k], GRAD_REL, k)
        losses[rung.get("kv_keep_stride", 1)] = float(tl.detach())
    assert abs(losses[2] - losses[1]) > 1e-6, losses


@pytest.mark.parametrize("rung", [RUNGS[0], RUNGS[2]],
                         ids=[RUNG_IDS[0], RUNG_IDS[2]])
def test_three_train_steps_match_jax(setup, rung):
    """Three AdamW steps on the precise rung and on int8+kvstride2 (the
    int8 tolerances of the module docstring)."""
    loss_rel = INT8_LOSS_REL if rung else VAL_REL
    param_atol = INT8_PARAM_ATOL if rung else PARAM_ATOL
    jcfg, tcfg, jparams, np_tree, _ = setup
    cfg = jax_optim.OptConfig(lr=1e-3, warmup=20, total_steps=10)
    jstep = jax.jit(jax_step.make_train_step(jcfg, JaxKnobs(**rung),
                                             opt_cfg=cfg, remat="none"))
    tstep = t_step.make_train_step(tcfg, ApproxKnobs(**rung),
                                   opt_cfg=t_optim.OptConfig(*cfg),
                                   remat="full")
    src = SyntheticLM(DataConfig(jcfg.vocab_size, S, B, seed=1))
    jp, jo = jparams, jax_optim.init_opt(jparams)
    tp = _tparams(tcfg, np_tree)
    to = t_optim.init_opt(tp)
    for i in range(3):
        toks = src.batch(i)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.tensor(toks)})
        _close_rel(float(tm["loss"]), float(jm["loss"]), loss_rel,
                   f"loss {i}")
    got = _flat(convert.tree_to_numpy(dict(tp.named_parameters()), tcfg))
    want = _flat(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=param_atol,
                                   err_msg=k)
    got_m = _flat(convert.tree_to_numpy(to.m, tcfg))
    want_m = _flat(jax.tree.map(np.asarray, jo.m))
    for k in want_m:
        _close_rel(got_m[k], want_m[k],
                   INT8_GRAD_REL if rung else GRAD_REL, f"m {k}")


def test_launch_train_cpu_pliant_prints_final_loss():
    """``python -m repro_torch.launch.train --device cpu --pliant``: the
    driver's default arch is phi4-mini-3.8b-smoke, as in the JAX driver;
    with a decision every step the burst walks all four rungs."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = t_train.main(["--device", "cpu", "--pliant", "--steps", "8",
                            "--batch", "4", "--seq", "32",
                            "--decision-interval", "0"])
    out = buf.getvalue()
    assert "final loss" in out and "pliant actions" in out
    assert res["cfg"].name == ARCH
    assert np.isfinite(res["final_loss"]) and len(res["losses"]) == 8
    assert res["names"] == RUNG_IDS
    assert set(res["variants"]) == {0, 1, 2, 3}
