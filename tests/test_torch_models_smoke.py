"""Twin of ``tests/test_models_smoke.py`` for the port: every case runs on
the port and is held to the JAX package's result on the same fp32 weights
(``repro.models.api.init`` converted through numpy) and the same
numpy-seeded batch, on the CPU, at the reduced ("smoke") configs of all
ten archs. The train step of every arch, the remat policies and the
capacity drop are here; the approximate rungs, decode, micro-batches and
the experts' stacked int8 backward are in
``tests/test_torch_models_smoke_rungs.py`` (two files, so that pytest-xdist
workers run them side by side).

Tolerances: fp32 sums taken in other orders. Losses within 1e-5 relative
(1e-4 on the int8 rungs, where an input a rounding step away from a
quantisation boundary rounds the other way in one package and the
difference compounds over the layers), ``grad_norm`` within 1e-4
relative. After one AdamW step the parameters: the first update is
``lr * g / (|g| + eps)``, about ``lr * sign(g)``, so an entry whose
gradient is at the 1e-9 level moves by a fraction of lr that any fp32
reordering changes; all but 0.1% of each leaf's entries within 1e-5 of
the JAX package's (2% of the update lr = 5e-4), every entry within one
update (lr), and the total movement within 1e-4 relative. The
micro-batched step's parameters as the JAX test holds them (rtol 2e-3,
atol 2e-5); decode against the full forward at the JAX test's 3e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.approx.knobs import PRECISE as JAX_PRECISE
from repro.configs.base import MoEConfig as JaxMoE
from repro.models import api as jax_api
from repro.train import optim as jax_optim
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import PRECISE, ApproxKnobs
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.models import api as t_api
from repro_torch.models import lm as t_lm
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

ALL = list(jax_configs.ARCHS)
VAL_REL, INT8_REL, NORM_REL, PARAM_ATOL = 1e-5, 1e-4, 1e-4, 1e-5
OPT = dict(lr=1e-3, warmup=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def model(name):
    """(JAX cfg, port cfg, JAX params, numpy tree) of ``name``'s smoke
    config, made once."""
    if name not in _MODELS:
        jcfg = jax_configs.get_config(name + "-smoke")
        tcfg = t_configs.get_config(name + "-smoke")
        jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
        _MODELS[name] = (jcfg, tcfg, jp, jax.tree.map(np.asarray, jp))
    return _MODELS[name]


def _batch(cfg, B=2, S=32, seed=1):
    """The JAX test's batch shapes, drawn with numpy: (jax batch, port
    batch)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)
                                ).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                 ).astype(np.float32)
    if cfg.family == "vlm":
        b["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _rel(got, want, rel, what=""):
    np.testing.assert_allclose(float(got), float(want), rtol=rel, atol=0,
                               err_msg=what)


def _steps(name, knobs, B=2, n_micro=1):
    """One train step of each package from the same weights and batch:
    (JAX params, opt, metrics), (port params, opt, metrics)."""
    jcfg, tcfg, jp, np_tree = model(name)
    jb, tb = _batch(jcfg, B=B)
    jstep = jax.jit(jax_step.make_train_step(
        jcfg, JaxKnobs(**knobs), opt_cfg=jax_optim.OptConfig(**OPT),
        remat="none", n_micro=n_micro))
    jres = jstep(jp, jax_optim.init_opt(jp), jb)
    tp = params_from_numpy(np_tree, tcfg)
    tstep = t_step.make_train_step(
        tcfg, ApproxKnobs(**knobs), opt_cfg=t_optim.OptConfig(**OPT),
        remat="full", n_micro=n_micro)
    tres = tstep(tp, t_optim.init_opt(tp), tb)
    return jres, tres


def _params_np(params, cfg):
    return jax.tree.leaves(tree_to_numpy(dict(params.named_parameters()),
                                         cfg))


@pytest.mark.parametrize("name", ALL)
def test_forward_and_train_step(name):
    """One train step on every arch: the loss and ``grad_norm`` equal the
    JAX step's, finite and positive; every parameter keeps its shape and
    dtype, the parameters moved, and to where the JAX step moved them;
    the optimizer counted one step."""
    (jp2, jopt2, jm), (tp2, topt2, tm) = _steps(name, {})
    tcfg = model(name)[1]
    assert np.isfinite(float(tm["loss"])), name
    assert np.isfinite(float(tm["grad_norm"])) and float(tm["grad_norm"]) > 0
    _rel(tm["loss"], jm["loss"], VAL_REL, "loss")
    _rel(tm["grad_norm"], jm["grad_norm"], NORM_REL, "grad_norm")
    before = jax.tree.leaves(model(name)[3])
    after = _params_np(tp2, tcfg)
    moved = moved_jax = 0.0
    for a, b, want in zip(before, after, jax.tree.leaves(jp2)):
        want = np.asarray(want)
        assert a.shape == b.shape and a.dtype == b.dtype
        moved += float(np.abs(a - b).sum())
        moved_jax += float(np.abs(a - want).sum())
        off = np.abs(b - want)
        assert (off > PARAM_ATOL).mean() <= 1e-3, (off > PARAM_ATOL).sum()
        assert off.max() <= OPT["lr"], off.max()
    assert moved > 0
    _rel(moved, moved_jax, 1e-4, "total movement")
    assert topt2.step == int(jopt2.step) == 1


@pytest.mark.parametrize("n_layers", [0, 4], ids=["smoke", "4-layers"])
def test_remat_policies_equal_loss(n_layers):
    """mistral-large-123b-smoke, as in the JAX test (its 2 layer groups
    make "2level" fall back to "full"), and cut to 4 layers (2 x 2 nested
    checkpoints): the loss under none / full / 2level / dots, equal to
    each other and to the JAX package's (under "none" and "2level"), and
    the gradients of the others against "none"'s."""
    jcfg, tcfg, jp, np_tree = model("mistral-large-123b")
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
        jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
        np_tree = jax.tree.map(np.asarray, jp)
        assert t_lm.near_sqrt_factors(tcfg.n_groups) == (2, 2)
    jb, tb = _batch(jcfg)
    want = [float(jax.jit(lambda p, b, r=r: jax_api.loss_fn(jcfg)(
        p, b, knobs=JAX_PRECISE, remat=r)[0])(jp, jb))
        for r in ("none", "2level")]
    lf = t_api.loss_fn(tcfg)
    vals, grads = [], []
    for remat in ["none", "full", "2level", "dots"]:
        tp = params_from_numpy(np_tree, tcfg).requires_grad_(True)
        loss, _ = lf(tp, tb, knobs=PRECISE, remat=remat)
        vals.append(float(loss.detach()))
        grads.append(torch.autograd.grad(loss, list(tp.parameters())))
    for v in vals:
        _rel(v, vals[0], VAL_REL)
        for w in want:
            _rel(v, w, VAL_REL, "JAX")
    for g in grads[1:]:
        for a, b in zip(g, grads[0]):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


def test_remat_dots_saves_the_matmuls_and_prime_falls_back():
    """"dots" keeps the 2-D matmuls' outputs for the backward and
    recomputes the rest: one layer's backward under "dots" re-runs no
    ``mm`` but the norms and attention again; a prime group count makes
    "2level" the "full" policy."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    tcfg = model("phi4-mini-3.8b")[1]
    _, _, _, np_tree = model("phi4-mini-3.8b")
    _, tb = _batch(tcfg)
    counts = {}
    for remat in ("none", "dots", "full"):
        tp = params_from_numpy(np_tree, tcfg).requires_grad_(True)
        loss, _ = t_lm.lm_loss(tp, tb, tcfg, remat=remat)
        with Count() as c:
            torch.autograd.grad(loss, list(tp.parameters()))
        counts[remat] = c.n
    mm = torch.ops.aten.mm.default
    # "dots" recomputes no projection: its backward runs the products of
    # "none"'s; "full" runs the forward's projections again
    assert counts["dots"].get(mm, 0) == counts["none"].get(mm, 0)
    assert counts["full"].get(mm, 0) > counts["none"].get(mm, 0)
    assert sum(counts["dots"].values()) > sum(counts["none"].values())
    assert t_lm.near_sqrt_factors(7) == (1, 7)
    assert t_lm.near_sqrt_factors(12) == (3, 4)


def test_moe_capacity_drops_tokens_but_stays_finite():
    """olmoe-1b-7b-smoke at capacity factor 0.25: entries dropped, the
    loss finite and equal to the JAX package's."""
    jcfg, tcfg, jp, np_tree = model("olmoe-1b-7b")
    m = tcfg.moe
    jcfg = dataclasses.replace(
        jcfg, moe=JaxMoE(m.n_experts, m.top_k, capacity_factor=0.25))
    tcfg = dataclasses.replace(
        tcfg, moe=MoEConfig(m.n_experts, m.top_k, capacity_factor=0.25))
    jb, tb = _batch(jcfg)
    want, _ = jax.jit(lambda p, b: jax_api.loss_fn(jcfg)(
        p, b, knobs=JAX_PRECISE, remat="none"))(jp, jb)
    got, _ = t_api.loss_fn(tcfg)(params_from_numpy(np_tree, tcfg), tb,
                                 knobs=PRECISE, remat="none")
    assert torch.isfinite(got)
    _rel(got, want, VAL_REL)
