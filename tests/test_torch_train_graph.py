"""The train step as the table's executable (``train/step.py``
``TrainStep`` / ``GraphedTrainStep``, ``launch/train.py``
``build_variant_steps``) on the CPU, against the JAX package and against
the eager step, at the smoke configs, on one torch thread.

- The schedule scalars the update reads from a tensor
  (``optim.schedule``) against the JAX package's ``lr_at`` and bias
  corrections over warm-up, cosine and past ``total_steps``: equal but for
  ``cos`` (2 fp32 ulps of the peak lr, as ``tests/test_torch_substrate.py``
  sets out).
- Three steps over a rung switch (precise, int8, int8+drop50%) on
  mamba2-780m-smoke and phi4-mini-3.8b-smoke against the JAX package's
  jitted steps, under the tolerances the suite already holds each arch's
  int8 rungs to: mamba2 ``tests/test_torch_train.py``'s (losses and grad
  norms within 1e-5 relative, parameters within 1e-5 absolute after the
  three steps: 1% of one step at lr 1e-3); phi4-mini
  ``tests/test_torch_attn_train.py``'s int8 ones (1e-4 relative, 2e-4
  absolute: an MLP input within an ulp of a rounding boundary flips by
  one int8 code between the packages, as that file's docstring sets
  out; at the 1e-5 bound 2 of mlp/wo's 16,384 entries fail by 3.4e-5).
- The captured step's protocol (the batch copied into static buffers, the
  scalars written, the body run on them, the metrics copied out), run
  uncaptured on the CPU, against the eager step over the same steps: equal
  bit for bit (the same ops on the same values).
- ``load_state`` keeps the parameters' and moments' addresses, which a
  captured step holds; the protocol refuses moved state and other shapes.
- ``build_variant_steps`` on the CPU gives the eager steps.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.approx.knobs import ApproxKnobs as JaxKnobs
from repro.models import api as jax_api
from repro.train import optim as jax_optim
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.approx.knobs import ApproxKnobs
from repro_torch.ckpt.checkpoint import load_state, state_tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.explorer import explore
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as t_train
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

B, S = 4, 32
# a rung switch at every step: precise, then int8, then int8 with half the
# batch rows dropped (both archs' ladders hold these three)
SWITCH = [dict(), dict(matmul_precision="int8"),
          dict(matmul_precision="int8", token_drop=0.5)]
# each arch's remat and its (value rel, parameter atol) over the switch
ARCHS = {"mamba2-780m-smoke": ("none", (1e-5, 1e-5)),
         "phi4-mini-3.8b-smoke": ("full", (1e-4, 2e-4))}
LR_ULPS = 2
OPT = dict(lr=1e-3, warmup=2, total_steps=10)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    jcfg = jax_configs.get_config(request.param)
    tcfg = t_configs.get_config(request.param)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, tcfg, jparams, np_tree, ARCHS[request.param]


def _tparams(tcfg, np_tree):
    return convert.params_from_numpy(np_tree, tcfg).requires_grad_(True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _batches(vocab, n):
    src = SyntheticLM(DataConfig(vocab, S, B, seed=1))
    return [src.batch(i) for i in range(n)]


@pytest.mark.parametrize("step", [0, 1, 2, 5, 9, 10, 50, 80])
def test_schedule_matches_jax(step):
    """Warm-up (steps 0-9), the peak (10), the cosine (50) and past
    ``total_steps`` (80): ``lr``, ``b1c`` and ``b2c`` as JAX's update
    computes them, the bias corrections exactly; ``schedule_on`` writes
    the same values into a given tensor."""
    kw = dict(lr=3e-4, warmup=10, total_steps=60)
    jcfg, tcfg = jax_optim.OptConfig(**kw), t_optim.OptConfig(**kw)
    js = jnp.asarray(step, jnp.int32)
    t = (js + 1).astype(jnp.float32)
    want = np.asarray([jax_optim.lr_at(jcfg, js), 1.0 - jcfg.b1 ** t,
                       1.0 - jcfg.b2 ** t], np.float32)
    got = t_optim.schedule(tcfg, step)
    assert got.dtype == torch.float32 and got.shape == (3,)
    got = got.numpy()
    np.testing.assert_array_equal(got[1:], want[1:])
    assert abs(got[0] - want[0]) <= LR_ULPS * np.spacing(
        np.float32(kw["lr"]))
    out = torch.full((3,), float("nan"))
    assert t_optim.schedule_on(tcfg, step, "cpu", out=out) is out
    np.testing.assert_array_equal(out.numpy(), got)


def test_three_steps_across_rungs_match_jax(arch):
    """precise -> int8 -> int8+drop50%, one step each, through the
    refactored step (remat "full" on phi4-mini) and the JAX package's
    jitted steps (remat "none") from the same weights on the same
    batches."""
    jcfg, tcfg, jparams, np_tree, (remat, (val_rel, param_atol)) = arch
    jcfg_opt = jax_optim.OptConfig(**OPT)
    jp, jo = jparams, jax_optim.init_opt(jparams)
    tp = _tparams(tcfg, np_tree)
    to = t_optim.init_opt(tp)
    for i, (rung, toks) in enumerate(zip(SWITCH, _batches(jcfg.vocab_size,
                                                          3))):
        jstep = jax.jit(jax_step.make_train_step(
            jcfg, JaxKnobs(**rung), opt_cfg=jcfg_opt, remat="none"))
        tstep = t_step.make_train_step(tcfg, ApproxKnobs(**rung),
                                       opt_cfg=t_optim.OptConfig(**OPT),
                                       remat=remat)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(toks)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.tensor(toks)})
        assert to.step == int(jo.step) == i + 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=val_rel, err_msg=f"{k} {i}")
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= \
            LR_ULPS * np.spacing(np.float32(OPT["lr"]))
    got = _flat(convert.tree_to_numpy(dict(tp.named_parameters()), tcfg))
    want = _flat(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=param_atol,
                                   err_msg=k)


def _state_equal(a, b):
    (pa, oa), (pb, ob) = a, b
    assert oa.step == ob.step
    for x, y in zip(t_step.state_tensors(pa, oa),
                    t_step.state_tensors(pb, ob)):
        assert torch.equal(x, y)


def test_protocol_equals_eager_bit_for_bit(arch):
    """The same three steps over the rung switch, once through the eager
    ``TrainStep``s and once through ``GraphedTrainStep``s on the CPU (the
    static-buffer protocol, uncaptured), from copies of the same state:
    losses, grad norms, learning rates, parameters and both AdamW moments
    equal bit for bit after every step."""
    jcfg, tcfg, _, np_tree, (remat, _) = arch
    opt_cfg = t_optim.OptConfig(**OPT)
    eager = [t_step.make_train_step(tcfg, ApproxKnobs(**r), opt_cfg=opt_cfg,
                                    remat=remat) for r in SWITCH]
    graphed = [t_step.GraphedTrainStep(s, "cpu") for s in eager]
    p0 = _tparams(tcfg, np_tree)
    runs = []
    for steps in (eager, graphed):
        p = copy.deepcopy(p0)
        runs.append([p, t_optim.init_opt(p)])
    for i, toks in enumerate(_batches(jcfg.vocab_size, 3)):
        metrics = []
        for run, steps in zip(runs, (eager, graphed)):
            run[0], run[1], m = steps[i](run[0], run[1],
                                         {"tokens": torch.tensor(toks)})
            metrics.append(m)
        assert metrics[0].keys() == metrics[1].keys()
        for k in metrics[0]:
            a, b = metrics[0][k], metrics[1][k]
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), k
        _state_equal(*runs)
    assert [g.stats["replays"] for g in graphed] == [0, 0, 0]


def test_load_state_keeps_addresses_the_graph_holds(arch):
    """A restore (``load_state`` of another state's ``state_tree``) copies
    into the parameters and moments: their addresses stay, their values
    become the other state's, and a captured step's protocol takes the
    restored state; a new parameter tree, or a batch of another shape, it
    refuses."""
    jcfg, tcfg, _, np_tree, (remat, _) = arch
    opt_cfg = t_optim.OptConfig(**OPT)
    step = t_step.GraphedTrainStep(t_step.make_train_step(
        tcfg, opt_cfg=opt_cfg, remat=remat), "cpu")
    toks = _batches(jcfg.vocab_size, 2)
    p = _tparams(tcfg, np_tree)
    o = t_optim.init_opt(p)
    p, o, _ = step(p, o, {"tokens": torch.tensor(toks[0])})
    # another state: one more eager step from a copy
    q = copy.deepcopy(p)
    q, qo, _ = t_step.make_train_step(tcfg, opt_cfg=opt_cfg, remat=remat)(
        q, copy.deepcopy(o), {"tokens": torch.tensor(toks[1])})
    ptrs = [t.data_ptr() for t in t_step.state_tensors(p, o)]
    p, o = load_state(state_tree((q, qo), tcfg), (p, o), tcfg)
    assert [t.data_ptr() for t in t_step.state_tensors(p, o)] == ptrs
    _state_equal((p, o), (q, qo))
    p, o, m = step(p, o, {"tokens": torch.tensor(toks[0])})
    assert o.step == 3 and np.isfinite(float(m["loss"]))
    with pytest.raises(RuntimeError, match="moved"):
        step(q, qo, {"tokens": torch.tensor(toks[0])})
    with pytest.raises(ValueError, match="differs"):
        step(p, o, {"tokens": torch.tensor(toks[0][:2])})


def test_build_variant_steps_cpu_gives_eager_steps():
    """On the CPU the table holds the eager ``TrainStep``s (a CUDA device
    would give ``GraphedTrainStep``s); ``graphed_train_step`` passes a CPU
    step through."""
    cfg = t_configs.get_config("mamba2-780m-smoke")
    table = explore(cfg, ShapeConfig("cli", S, B, "train"), serving=False,
                    max_variants=4)
    steps = t_train.build_variant_steps(cfg, table,
                                        t_optim.OptConfig(**OPT),
                                        device=torch.device("cpu"))
    assert len(steps) == len(table) == 4
    for i, s in enumerate(steps):
        assert type(s) is t_step.TrainStep and table.executable(i) is s
        assert s.knobs == table.variants[i].knobs
        assert t_step.graphed_train_step(s, "cpu") is s


def test_replayed_launches_count_capture_times_replays():
    """Each graph's launches at its capture times its replays, summed over
    the steps that have graphs; eager steps add nothing."""
    a = t_step.GraphedTrainStep(None, "cpu")
    b = t_step.GraphedTrainStep(None, "cpu")
    a.stats.update(replays=3, launches={"ssd_scan": 4, "int8_matmul": 6})
    b.stats.update(replays=2, launches={"ssd_scan": 4, "int8_matmul": 0})
    got = t_step.replayed_launches([a, b, object()])
    assert got == {"flash_attention": 0, "int8_matmul": 18,
                   "quantize_rows": 0, "ssd_scan": 20,
                   "ssd_scan_backward": 0}
