"""Twin of ``tests/test_substrate.py``'s optimizer and data cases on the
port's ``train/optim.py`` and ``data/pipeline.py``: the same inputs go
through both packages (the checkpoint cases are twinned in
``tests/test_torch_ckpt.py``).

Tolerances: the two optimizers run the same fp32 arithmetic in other
kernels, so parameters agree within 1e-6 absolute over 200 steps of the
quadratic (each step moves an entry by at most lr = 0.1, carried through
the moments); the learning rate within 2 fp32 ulps of the peak lr (XLA's
and PyTorch's ``cos`` differ by an ulp of a value near 1, which the
cosine's ``0.5 * lr * (1 + cos)`` carries at the peak's scale). The data
source is numpy in both packages: equal, not close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.train import optim as jax_optim
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.train import optim

LR_ULPS = 2


def _params(w):
    return torch.nn.ParameterDict(
        {"w": torch.nn.Parameter(torch.tensor(w, dtype=torch.float32))})


# ---------------------------------------------------------------- optimizer

def test_adamw_converges_on_quadratic():
    """200 AdamW steps on sum((w - target)^2) from zero in both packages:
    both converge, along the same trajectory."""
    target = np.asarray([1.5, -2.0, 0.5], np.float32)
    kw = dict(lr=0.1, warmup=5, total_steps=200, weight_decay=0.0)
    jparams = {"w": jnp.zeros(3)}
    jopt = jax_optim.init_opt(jparams)
    jcfg = jax_optim.OptConfig(**kw)
    jloss = lambda p: jnp.sum((p["w"] - target) ** 2)
    tparams = _params(np.zeros(3, np.float32))
    topt = optim.init_opt(tparams)
    tcfg = optim.OptConfig(**kw)
    tt = torch.tensor(target)
    for i in range(200):
        g = jax.grad(jloss)(jparams)
        jparams, jopt, _ = jax_optim.adamw_update(g, jopt, jparams, jcfg)
        tg = {"w": 2.0 * (tparams["w"].detach() - tt)}
        tparams, topt, _ = optim.adamw_update(tg, topt, tparams, tcfg)
        np.testing.assert_allclose(tparams["w"].detach().numpy(),
                                   np.asarray(jparams["w"]), rtol=0,
                                   atol=1e-6, err_msg=f"step {i}")
    assert topt.step == int(jopt.step) == 200
    assert float(jloss(jparams)) < 1e-2
    assert float(((tparams["w"].detach() - tt) ** 2).sum()) < 1e-2


def test_grad_clip_bounds_update():
    """A gradient of 1e6 per entry: both report the raw norm, and the
    clipped update moves each entry by the same lr-sized step."""
    kw = dict(lr=1e-3, clip_norm=1.0, warmup=0, total_steps=10)
    jparams = {"w": jnp.zeros(4)}
    jp, _, jm = jax_optim.adamw_update({"w": jnp.full(4, 1e6)},
                                       jax_optim.init_opt(jparams), jparams,
                                       jax_optim.OptConfig(**kw))
    tparams = _params(np.zeros(4, np.float32))
    tp, _, tm = optim.adamw_update({"w": torch.full((4,), 1e6)},
                                   optim.init_opt(tparams), tparams,
                                   optim.OptConfig(**kw))
    assert float(tm["grad_norm"]) > 1e5            # reported raw norm
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    step = tp["w"].detach().numpy()
    np.testing.assert_allclose(step, np.asarray(jp["w"]), rtol=0, atol=1e-9)
    assert np.all(np.abs(step) <= 1e-3 * (1 + 1e-6))


def test_lr_schedule_shape():
    """Warm-up rises, peaks at lr, the cosine decays to ~0: the port's
    ``lr_at`` and the ``lr`` its update reads (``optim.schedule``) follow
    the JAX package's at every step."""
    kw = dict(lr=1.0, warmup=10, total_steps=110)
    jcfg, tcfg = jax_optim.OptConfig(**kw), optim.OptConfig(**kw)
    want = np.asarray([jax_optim.lr_at(jcfg, jnp.asarray(s, jnp.int32))
                       for s in range(110)], np.float32)
    lrs = np.asarray([optim.lr_at(tcfg, s) for s in range(110)], np.float32)
    read = np.asarray([optim.schedule(tcfg, s)[0] for s in range(110)])
    np.testing.assert_array_equal(read, lrs)
    tol = LR_ULPS * np.spacing(np.float32(kw["lr"]))
    assert np.all(np.abs(lrs - want) <= tol), np.abs(lrs - want).max()
    assert lrs[0] < lrs[9]                  # warmup rises
    assert abs(lrs[10] - 1.0) < 0.02        # peak
    assert lrs[-1] < 0.02                   # cosine decays to ~0


# --------------------------------------------------------------------- data

def test_data_deterministic():
    kw = dict(vocab_size=101, seq_len=32, global_batch=4, seed=7)
    a = SyntheticLM(DataConfig(**kw)).batch(3)
    b = SyntheticLM(DataConfig(**kw)).batch(3)
    np.testing.assert_array_equal(a, b)
    c = SyntheticLM(DataConfig(**kw)).batch(4)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a, JaxSyntheticLM(JaxDataConfig(**kw))
                                  .batch(3))


# the JAX test draws (n_hosts, step) with hypothesis; here each pair it can
# draw at the edges and in the middle is a case of its own
@pytest.mark.parametrize("n_hosts,step", [(2, 0), (2, 5), (4, 3), (8, 1),
                                          (16, 0), (16, 5)])
def test_data_host_shards_partition_global_batch(n_hosts, step):
    kw = dict(vocab_size=97, seq_len=16, global_batch=8 * n_hosts, seed=3)
    shards = [SyntheticLM(DataConfig(**kw), host_id=h,
                          n_hosts=n_hosts).batch(step)
              for h in range(n_hosts)]
    ref = SyntheticLM(DataConfig(**kw), host_id=0, n_hosts=1).batch(step)
    np.testing.assert_array_equal(np.concatenate(shards), ref)
    for h, shard in enumerate(shards):
        np.testing.assert_array_equal(shard, JaxSyntheticLM(
            JaxDataConfig(**kw), host_id=h, n_hosts=n_hosts).batch(step))


def test_data_in_vocab_and_learnable():
    kw = dict(vocab_size=53, seq_len=64, global_batch=8, seed=0)
    b = SyntheticLM(DataConfig(**kw)).batch(0)
    assert b.min() >= 0 and b.max() < 53
    # copy motif present: position t % 16 == 0 repeats t-8 for t >= 8
    hits = np.mean([b[i, t] == b[i, t - 8]
                    for i in range(8) for t in range(16, 65, 16)])
    assert hits == 1.0
    np.testing.assert_array_equal(b, JaxSyntheticLM(JaxDataConfig(**kw))
                                  .batch(0))


def test_prefetcher_orders_steps():
    kw = dict(vocab_size=31, seq_len=8, global_batch=2, seed=1)
    src, jsrc = SyntheticLM(DataConfig(**kw)), JaxSyntheticLM(
        JaxDataConfig(**kw))
    pf = Prefetcher(lambda s: src.batch(s), start_step=5)
    jpf = JaxPrefetcher(lambda s: jsrc.batch(s), start_step=5)
    try:
        got = [next(pf) for _ in range(4)]
        want = [next(jpf) for _ in range(4)]
    finally:
        pf.close()
        jpf.close()
    assert [s for s, _ in got] == [s for s, _ in want] == [5, 6, 7, 8]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
