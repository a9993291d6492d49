"""The port's training path against the JAX package on mamba2-780m-smoke,
on the CPU: the same fp32 weights (``repro.models.api.init``, converted
through numpy with ``repro_torch.convert``) and the same numpy batches go
through both; the port's gradients are restacked into the JAX layout
(``convert.tree_to_numpy``) and compared leaf by leaf.

Tolerances: fp32 sums taken in other orders. Values (mixer outputs,
losses) within 1e-5 relative; gradients within 1e-4 of each leaf's largest
entry (reductions over the batch, sequence and the chunked scan's pairs);
after three optimizer steps parameters within 1e-5 absolute (an update is
at most lr = 1e-3 per step, so that is 1% of one step). On the int8 rungs
the gradient reaches only the arg-max entry of each row / column through
the quantisation scales: the zero pattern must be equal, not close."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.configs.base import ShapeConfig as JaxShape
from repro.core.explorer import explore as jax_explore
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import api as jax_api
from repro.models import common as jax_common
from repro.models import lm as jax_lm
from repro.models import mamba2 as jax_mamba
from repro.train import optim as jax_optim
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.explorer import explore
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as t_train
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.models import mamba2 as t_mamba
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

ARCH = "mamba2-780m-smoke"
B, S = 4, 32
# the explorer's training ladder for this arch (test_train_ladder holds it)
RUNGS = [dict(), dict(matmul_precision="int8"),
         dict(matmul_precision="int8", token_drop=0.125),
         dict(matmul_precision="int8", token_drop=0.5)]
RUNG_IDS = ["precise", "int8", "int8+drop12%", "int8+drop50%"]
VAL_REL, GRAD_REL, PARAM_ATOL = 1e-5, 1e-4, 1e-5


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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _close_rel(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()),
                                              1e-30), err_msg=what)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_mamba_mixer_matches_jax(setup, precision):
    jcfg, tcfg, jparams, np_tree, _ = setup
    x = np.random.default_rng(1).normal(size=(2, 32, jcfg.d_model)
                                        ).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["pos0"]["mixer"])
    want = jax.jit(lambda p, h: jax_mamba.mamba_mixer(
        p, h, jcfg, precision=precision))(jp, jnp.asarray(x))
    tp = convert.params_from_numpy(np_tree, tcfg).layers[0].mixer
    got = t_mamba.mamba_mixer(tp, torch.tensor(x), tcfg, precision=precision)
    _close_rel(got.detach().numpy(), want, VAL_REL, precision)


@pytest.mark.parametrize("rung", RUNGS, ids=RUNG_IDS)
def test_lm_loss_and_grads_match_jax(setup, rung):
    """``lm_loss`` and its whole gradient tree against
    ``jax.value_and_grad`` on each rung of the training ladder."""
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
        _close_rel(got[k], want[k], GRAD_REL, k)
        if rung:                     # int8: the scales carry the gradient
            assert np.array_equal(got[k] != 0, want[k] != 0), k
    if rung:
        w = want["groups/pos0/mixer/in_x"]
        assert 0 < np.count_nonzero(w) <= w.shape[0] * w.shape[2]


def test_rms_norm_grads_match_jax_custom_vjp_bf16():
    """The hand-written VJP in bf16: (B,S,D) tensors stay bf16, only row
    statistics fp32; equal to the JAX ``custom_vjp`` within one bf16 step
    (2^-8) of each gradient's largest entry."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    dy = rng.normal(size=(2, 8, 64)).astype(np.float32)
    xj, sj, dyj = (jnp.asarray(t, jnp.bfloat16) for t in (x, scale, dy))
    yj, vjp = jax.vjp(lambda a, s: jax_common.rms_norm(a, s, 1e-6), xj, sj)
    dxj, dsj = vjp(dyj)
    xt, st, dyt = (torch.tensor(t).to(torch.bfloat16).requires_grad_(True)
                   for t in (x, scale, dy))
    yt = t_common.rms_norm(xt, st, 1e-6)
    dxt, dst = torch.autograd.grad(yt, (xt, st), dyt)
    assert dxt.dtype == torch.bfloat16 and dst.dtype == torch.bfloat16
    for got, want in ((yt, yj), (dxt, dxj), (dst, dsj)):
        _close_rel(got.detach().float().numpy(),
                   np.asarray(want, np.float32), 2.0 ** -8, "rms_norm")


def test_adamw_update_matches_jax(setup):
    """One AdamW step from moments already warm (step 3), with clipping
    active and the stacked-leaf weight-decay rule."""
    jcfg, tcfg, jparams, np_tree, _ = setup
    rng = np.random.default_rng(3)
    flat = _flat(np_tree)
    g = {k: (rng.normal(size=v.shape) * 0.05).astype(np.float32)
         for k, v in flat.items()}
    m = {k: (rng.normal(size=v.shape) * 0.01).astype(np.float32)
         for k, v in flat.items()}
    v2 = {k: np.abs(rng.normal(size=v.shape) * 1e-3).astype(np.float32)
          for k, v in flat.items()}

    cfg = jax_optim.OptConfig(lr=1e-3, warmup=2, total_steps=10)
    jopt = jax_optim.OptState(jnp.asarray(3, jnp.int32),
                              jax.tree.map(jnp.asarray, _unflat(m)),
                              jax.tree.map(jnp.asarray, _unflat(v2)))
    jp, jo, jm = jax.jit(jax_optim.adamw_update, static_argnums=3)(
        jax.tree.map(jnp.asarray, _unflat(g)), jopt, jparams, cfg)
    tp = _tparams(tcfg, np_tree)
    names = list(dict(tp.named_parameters()))
    t_of = _t_of(tcfg, names)
    topt = t_optim.OptState(3, {n: t_of(m, n) for n in names},
                            {n: t_of(v2, n) for n in names})
    tp, to, tm = t_optim.adamw_update({n: t_of(g, n) for n in names}, topt,
                                      tp, t_optim.OptConfig(*cfg))
    assert to.step == 4
    _close_rel(float(tm["grad_norm"]), float(jm["grad_norm"]), VAL_REL, "gn")
    assert np.float32(tm["lr"]) == np.float32(jm["lr"])
    got = _flat(convert.tree_to_numpy(dict(tp.named_parameters()), tcfg))
    want = _flat(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    got_m = _flat(convert.tree_to_numpy(to.m, tcfg))
    want_m = _flat(jax.tree.map(np.asarray, jo.m))
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-6,
                                   atol=1e-9, err_msg=k)


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _t_of(tcfg, names):
    """name of a port parameter -> its slice of a JAX-layout flat dict."""
    period = len(tcfg.pattern)

    def get(flat, name):
        parts = name.split(".")
        if parts[0] != "layers":
            return torch.tensor(flat[name])
        g, j = divmod(int(parts[1]), period)
        key = "/".join(["groups", f"pos{j}"] + parts[2:])
        return torch.tensor(flat[key][g])
    return get


@pytest.mark.parametrize("rung", [RUNGS[0], RUNGS[2]],
                         ids=[RUNG_IDS[0], RUNG_IDS[2]])
def test_three_train_steps_match_jax(setup, rung):
    jcfg, tcfg, jparams, np_tree, _ = setup
    cfg = jax_optim.OptConfig(lr=1e-3, warmup=20, total_steps=10)
    jstep = jax.jit(jax_step.make_train_step(jcfg, JaxKnobs(**rung),
                                             opt_cfg=cfg, remat="none"))
    tstep = t_step.make_train_step(tcfg, ApproxKnobs(**rung),
                                   opt_cfg=t_optim.OptConfig(*cfg),
                                   remat="none")
    src = SyntheticLM(DataConfig(jcfg.vocab_size, S, B, seed=1))
    jp, jo = jparams, jax_optim.init_opt(jparams)
    tp = _tparams(tcfg, np_tree)
    to = t_optim.init_opt(tp)
    for i in range(3):
        toks = src.batch(i)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.tensor(toks)})
        _close_rel(float(tm["loss"]), float(jm["loss"]), VAL_REL, f"loss {i}")
    got = _flat(convert.tree_to_numpy(dict(tp.named_parameters()), tcfg))
    want = _flat(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_micro_batches_accumulate_like_one_batch(setup):
    """``n_micro=2`` sums fp32 gradients of two half batches: the same step
    as one full batch, up to fp32 reassociation."""
    _, tcfg, _, np_tree, tokens = setup
    batch = {"tokens": torch.tensor(tokens)}
    outs = []
    for n_micro in (1, 2):
        tp = _tparams(tcfg, np_tree)
        step = t_step.make_train_step(tcfg, n_micro=n_micro, remat="none")
        tp, _, m = step(tp, t_optim.init_opt(tp), batch)
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     tp.final_norm.detach().clone()))
    assert abs(outs[0][0] - outs[1][0]) <= VAL_REL * abs(outs[0][0])
    assert abs(outs[0][1] - outs[1][1]) <= 1e-4 * outs[0][1]
    torch.testing.assert_close(outs[0][2], outs[1][2], rtol=0, atol=1e-6)


def test_synthetic_batches_equal():
    for seed in (0, 3):
        j = JaxSyntheticLM(JaxDataConfig(256, 32, 4, seed=seed))
        t = SyntheticLM(DataConfig(256, 32, 4, seed=seed))
        for step in (0, 5):
            np.testing.assert_array_equal(t.batch(step), j.batch(step))


# phi4-mini's ladder has the attention perforation rung where mamba2 has a
# second token-drop rung
PHI4_RUNG_IDS = ["precise", "int8", "int8+kvstride2", "int8+drop50%"]


@pytest.mark.parametrize("arch,seq,batch", [("mamba2-780m", 1024, 4),
                                            (ARCH, S, B),
                                            ("phi4-mini-3.8b", 4096, 2)])
def test_train_ladder_equals_jax(arch, seq, batch):
    jt = jax_explore(jax_configs.get_config(arch),
                     JaxShape("cli", seq, batch, "train"), serving=False,
                     max_variants=4)
    tt = explore(t_configs.get_config(arch),
                 ShapeConfig("cli", seq, batch, "train"), serving=False,
                 max_variants=4)
    assert [v.name for v in tt.variants] == [v.name for v in jt.variants] \
        == (PHI4_RUNG_IDS if arch.startswith("phi4") else RUNG_IDS)
    for a, b in zip(tt.variants, jt.variants):
        assert a.knobs.__dict__ == b.knobs.__dict__
        assert a.quality_loss == pytest.approx(b.quality_loss, abs=1e-12)
        assert a.rel_time == pytest.approx(b.rel_time, rel=1e-9)


def test_configs_match_jax():
    for arch in ("mamba2-780m", ARCH):
        j, t = jax_configs.get_config(arch), t_configs.get_config(arch)
        assert t.param_count() == j.param_count()
        assert t.ssm.__dict__ == j.ssm.__dict__
    full = t_configs.get_config("mamba2-780m")
    assert (full.n_layers, full.d_model, full.ssm.d_state,
            full.vocab_size) == (48, 1536, 128, 50280)
    assert 0.7e9 < full.param_count() < 0.85e9
    tp = t_lm.init_lm(t_configs.get_config(ARCH), 0, torch.float32, "cpu")
    assert sum(p.numel() for p in tp.parameters()) == \
        t_configs.get_config(ARCH).param_count()
    a_log = tp.layers[0].mixer.a_log
    assert a_log.dtype == torch.float32
    assert bool(((a_log >= 0) & (a_log <= np.log(16.0))).all())


def test_launch_train_cpu_pliant_prints_final_loss():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = t_train.main(["--arch", ARCH, "--device", "cpu", "--pliant",
                            "--steps", "8", "--batch", "4", "--seq", "32",
                            "--decision-interval", "0"])
    out = buf.getvalue()
    assert "final loss" in out and "pliant actions" in out
    assert np.isfinite(res["final_loss"]) and len(res["losses"]) == 8
    assert res["names"] == RUNG_IDS
    assert set(res["variants"]) == {0, 1, 2, 3}


def test_int8_grads_reach_only_the_argmax_entries():
    """Reference behaviour the port reproduces (ROADMAP queue 3): ``round``
    and the int8 cast have zero derivative, so the gradient of the W8A8
    product reaches x and w only through the row / column max that sets
    each quantisation scale: 4 of 32 x-grads and 5 of 40 w-grads nonzero
    for a (4,8)@(8,5) product, in both packages, at the same entries."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as t_ops
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    g = rng.normal(size=(4, 5)).astype(np.float32)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(
        jref.quantized_matmul_ref(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    tgx, tgw = torch.autograd.grad(
        (t_ops.quantized_matmul(xt, wt) * torch.tensor(g)).sum(), (xt, wt))
    for got, want, n in ((tgx, jgx, 4), (tgw, jgw, 5)):
        want = np.asarray(want)
        assert np.count_nonzero(want) == np.count_nonzero(got.numpy()) == n
        assert np.array_equal(got.numpy() != 0, want != 0)
        _close_rel(got.numpy(), want, 1e-6, "int8 grad")
    assert np.array_equal(np.flatnonzero(np.asarray(jgx)),
                          np.abs(x).argmax(1) + 8 * np.arange(4))
