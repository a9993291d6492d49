"""The port's checkpointing (``ckpt/checkpoint.py``) and the resume path of
its training driver, on the CPU: twins of ``tests/test_substrate.py``'s
four checkpoint cases, and checkpoints crossing between the packages in
both directions (the on-disk format is the JAX package's: ``shard0.npz``
with ``a{i}`` leaves in ``jax.tree.flatten`` order and
``manifest.json``).

Tolerances: restores are exact (the arrays round-trip through npz); a
step taken after a restore against the other package's step, loss within
1e-5 relative (fp32 sums taken in other orders); a resumed run's losses
equal to the uninterrupted run's bit for bit (same data, same kernels,
same order)."""
import pathlib
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.ckpt import checkpoint as jax_ck
from repro.models import api as jax_api
from repro.train import optim as jax_optim
from repro.train import step as jax_step
from repro_torch import configs as t_configs
from repro_torch.ckpt import checkpoint as ck
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.launch import train as t_train
from repro_torch.models import api as t_api
from repro_torch.train import optim as t_optim
from repro_torch.train import step as t_step

OPT = dict(lr=1e-3, warmup=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------- twins of test_substrate.py --

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": (torch.ones(3), torch.zeros(2, 2))}}


def _like(tree):
    return ck._map(lambda x: ck.LeafShape(x.shape), tree)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ck.save(tmp_path / "step_5", t, 5)
    restored, step = ck.restore(tmp_path / "step_5", _like(t))
    assert step == 5
    for a, b in zip(ck.flatten(t), ck.flatten(restored)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(restored["nested"]["c"], tuple)


def test_checkpoint_manager_async_retention_resume(tmp_path):
    mgr = ck.CheckpointManager(tmp_path, period=2, keep=2)
    t = _tree()
    for step in range(1, 9):
        t = ck._map(lambda x: x + 1 if x.dtype != torch.int32 else x, t)
        mgr.maybe_save(t, step)
    mgr.wait()
    assert ck.latest_step(tmp_path) == 8
    kept = sorted(int(p.name.split("_")[-1])
                  for p in pathlib.Path(tmp_path).glob("step_*"))
    assert len(kept) <= 2
    restored, step = mgr.restore_latest(_like(t))
    assert step == 8
    np.testing.assert_allclose(restored["a"], t["a"].numpy())


def test_checkpoint_atomicity_overwrite(tmp_path):
    t = _tree(0)
    ck.save(tmp_path / "step_1", t, 1)
    t2 = ck._map(lambda x: x * 2, t)
    ck.save(tmp_path / "step_1", t2, 1)     # overwrite is atomic
    restored, _ = ck.restore(tmp_path / "step_1", _like(t))
    np.testing.assert_allclose(restored["a"], t2["a"].numpy())
    assert not list(pathlib.Path(tmp_path).glob(".ckpt_tmp_*"))


def test_train_resume_continues(tmp_path):
    """checkpoint/restart through the port's ``launch/train.py``: the
    resumed run continues from the saved step."""
    res1 = t_train.main(["--device", "cpu", "--arch", "mamba2-780m-smoke",
                         "--steps", "16", "--batch", "4", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--ckpt-period", "8"])
    res2 = t_train.main(["--device", "cpu", "--arch", "mamba2-780m-smoke",
                         "--steps", "24", "--batch", "4", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--resume"])
    assert np.isfinite(res1["final_loss"]) and np.isfinite(res2["final_loss"])
    assert res2["start_step"] == 16 and len(res2["losses"]) == 8
    assert ck.latest_step(tmp_path) == 24


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "paligemma-3b-smoke"])
def test_resumed_losses_equal_uninterrupted_run(tmp_path, arch):
    """8 steps against 4 steps, a checkpoint, and ``--resume`` to 8: the
    resumed run reads the batches (tokens and the stub frontend's frames
    or patch embeddings) the uninterrupted run read at those steps, and
    its losses are the uninterrupted run's, bit for bit."""
    argv = ["--device", "cpu", "--arch", arch, "--batch", "4", "--seq",
            "16"]
    whole = t_train.main(argv + ["--steps", "8"])
    t_train.main(argv + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                         "--ckpt-period", "4"])
    assert ck.all_steps(tmp_path) == [4]
    res = t_train.main(argv + ["--steps", "8", "--ckpt-dir", str(tmp_path),
                               "--resume"])
    assert res["start_step"] == 4
    assert res["losses"] == whole["losses"][4:]
    assert ck.all_steps(tmp_path) == [8, 4]


def _hold_writes(monkeypatch):
    """Make every background checkpoint write wait for the returned event
    before it starts (a slow disk), so that whatever training does in the
    meantime happens while the write is pending."""
    go, save = threading.Event(), ck.save

    def held(*args, **kw):
        assert go.wait(60)
        save(*args, **kw)
    monkeypatch.setattr(ck, "save", held)
    return go


@pytest.mark.parametrize("to_host", ["default", "state_tree"])
def test_async_save_holds_the_state_of_its_step(tmp_path, monkeypatch,
                                                to_host):
    """An async save writes the values its step had, though the tensors
    (CPU tensors, whose ``numpy()`` is a view) are updated in place while
    the write is pending: the host copy is a copy."""
    go = _hold_writes(monkeypatch)
    if to_host == "default":
        state = _tree()
        live = [t for t in ck.flatten(state) if t.is_floating_point()]
        mgr = ck.CheckpointManager(tmp_path, period=1)
        like = _like(state)
        snap = ck._map(lambda x: x.numpy().copy(), state)
    else:
        cfg = t_configs.get_config("whisper-large-v3-smoke")
        params = t_api.init(cfg, 0, torch.float32, "cpu")
        opt = t_optim.init_opt(params)
        state = (params, opt)
        live = [*params.parameters(), *opt.m.values(), *opt.v.values()]
        with torch.no_grad():
            for t in live:
                t.normal_()
        mgr = ck.CheckpointManager(tmp_path, period=1,
                                   to_host=lambda st: ck.state_tree(st, cfg))
        like = ck.state_like(state, cfg)
        snap = ck._map(lambda x: np.array(x, copy=True),
                       ck.state_tree(state, cfg))
    mgr.save_async(state, 1)
    with torch.no_grad():
        for t in live:
            t.add_(1.0)
    go.set()
    mgr.wait()
    restored, step = mgr.restore_latest(like)
    assert step == 1
    for got, want in zip(ck.flatten(restored), ck.flatten(snap)):
        np.testing.assert_array_equal(got, want)


def test_resume_from_a_save_made_mid_run(tmp_path, monkeypatch):
    """8 steps checkpointing every 4, the step-4 write held until step 6
    has updated the state in place; then, the step-8 checkpoint removed,
    ``--resume`` to 8 from step 4: its losses are the uninterrupted run's,
    bit for bit."""
    go = _hold_writes(monkeypatch)
    maybe_save = ck.CheckpointManager.maybe_save

    def release_after_step_6(self, tree, step):
        if step == 6:
            go.set()
        return maybe_save(self, tree, step)
    monkeypatch.setattr(ck.CheckpointManager, "maybe_save",
                        release_after_step_6)
    argv = ["--device", "cpu", "--arch", "whisper-large-v3-smoke", "--batch",
            "4", "--seq", "16", "--steps", "8", "--ckpt-dir", str(tmp_path)]
    whole = t_train.main(argv + ["--ckpt-period", "4"])
    assert ck.all_steps(tmp_path) == [8, 4]
    shutil.rmtree(tmp_path / "step_8")
    res = t_train.main(argv + ["--resume"])
    assert res["start_step"] == 4
    assert res["losses"] == whole["losses"][4:]


def test_torn_checkpoint_is_skipped_with_the_warning(tmp_path, capsys):
    """A ``shard0.npz`` cut short (a kill mid-copy) is skipped with the
    warning, and the next older checkpoint restores."""
    mgr = ck.CheckpointManager(tmp_path, period=2)
    t = _tree()
    mgr.save_sync(t, 2)
    mgr.save_sync(ck._map(lambda x: x + 1, t), 4)
    shard = tmp_path / "step_4" / "shard0.npz"
    shard.write_bytes(shard.read_bytes()[:200])
    restored, step = mgr.restore_latest(_like(t))
    assert step == 2
    np.testing.assert_array_equal(restored["a"], t["a"].numpy())
    assert mgr.skipped == [str(tmp_path / "step_4")]
    assert "WARNING: skipping corrupt/partial checkpoint" in \
        capsys.readouterr().err


# ------------------------------------------------ across the two packages --

def _jax_steps(arch, n):
    """``n`` JAX train steps from ``api.init``: (cfg, params, opt, step_fn,
    batches); the batches are numpy-seeded, one a step."""
    jcfg = jax_configs.get_config(arch)
    jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    opt = jax_optim.init_opt(jp)
    step = jax.jit(jax_step.make_train_step(
        jcfg, opt_cfg=jax_optim.OptConfig(**OPT), remat="none"))
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(n + 1):
        b = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 17)
                                    ).astype(np.int32)}
        if jcfg.family == "encdec":
            b["frames"] = rng.normal(size=(2, jcfg.encoder_seq,
                                           jcfg.d_model)).astype(np.float32)
        batches.append(b)
    for b in batches[:n]:
        jp, opt, _ = step(jp, opt, {k: jnp.asarray(v) for k, v in b.items()})
    return jcfg, jp, opt, step, batches


@pytest.mark.parametrize("arch", ["whisper-large-v3-smoke",
                                  "olmoe-1b-7b-smoke"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, arch):
    """Two JAX train steps, a checkpoint by the JAX ``CheckpointManager``;
    restored into the port through ``restore_latest`` + ``load_state``
    (parameters, both moments and the step exact), the port's third step
    equals the JAX package's third step."""
    jcfg, jp, jopt, jstep, batches = _jax_steps(arch, 2)
    mgr = jax_ck.CheckpointManager(tmp_path, period=2)
    mgr.maybe_save((jp, jopt), 2)
    mgr.wait()
    tcfg = t_configs.get_config(arch)
    from repro_torch.models import api as t_api
    tp = t_api.init(tcfg, 1, torch.float32, "cpu")
    topt = t_optim.init_opt(tp)
    tmgr = ck.CheckpointManager(tmp_path, period=2)
    tree, step = tmgr.restore_latest(ck.state_like((tp, topt), tcfg))
    assert step == 2
    tp, topt = ck.load_state(tree, (tp, topt), tcfg)
    assert topt.step == 2
    got = ck.state_tree((tp, topt), tcfg)
    for a, b in zip(ck.flatten(got), jax.tree.leaves((jp, jopt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, _, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                for k, v in batches[2].items()})
    tstep = t_step.make_train_step(tcfg, opt_cfg=t_optim.OptConfig(**OPT),
                                   remat="none")
    _, _, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                for k, v in batches[2].items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port checkpoint (after one port train step, so the moments and
    the step are live) restored by the JAX ``restore`` into the JAX train
    state's structure: every leaf exact, the step an int32 scalar."""
    arch = "paligemma-3b-smoke"
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    topt = t_optim.init_opt(tp)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)),
        "prefix_embeds": torch.from_numpy(rng.normal(size=(
            2, tcfg.n_prefix_tokens, tcfg.d_model)).astype(np.float32))}
    tp, topt, _ = t_step.make_train_step(tcfg, remat="none")(tp, topt, batch)
    mgr = ck.CheckpointManager(tmp_path, period=1,
                               to_host=lambda st: ck.state_tree(st, tcfg))
    mgr.maybe_save((tp, topt), 1)
    mgr.wait()
    like = jax.eval_shape(lambda: (jp, jax_optim.init_opt(jp)))
    (rp, ropt), step = jax_ck.restore(tmp_path / "step_1", like)
    assert step == 1 and int(ropt.step) == 1
    assert ropt.step.dtype == jnp.int32 and ropt.step.shape == ()
    named = dict(tp.named_parameters())
    for got, want in ((rp, tree_to_numpy(named, tcfg)),
                      (ropt.m, tree_to_numpy(topt.m, tcfg)),
                      (ropt.v, tree_to_numpy(topt.v, tcfg))):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), b), got, want)
