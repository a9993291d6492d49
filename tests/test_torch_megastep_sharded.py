"""The port's megastep decode under a mesh, on the CPU: twin of
``tests/test_megastep_sharded.py``'s 2 cases.

* Megastep K 4 under mesh 2x4 (2 slot-affinity shards, one
  ``paged_attention`` call a shard a layer) gives the port's single-device
  per-step engine's tokens and the JAX single-device engine's, on all four
  smoke archs.
* The megastep pipeline survives ``revoke@4+2:2,restore@9`` on mesh 4x2:
  the re-home drains the in-flight megastep and drops the graph, migrates
  the pages, and every request completes with the unfaulted megastep
  run's tokens and the JAX single-device engine's; the pipeline is empty
  after the run. JAX donates the cache buffers; the port updates them in
  place, so its case has no donation to hold and is named for the
  pipeline.

On the CPU a megastep's K steps run eagerly; on the card each is a replay
of one CUDA graph (``chip_smoke.py``'s serve-elastic phase holds that
path). Torch runs on one thread (a module fixture)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.dist.elastic import FaultInjector
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import engine as t_engine

ARCHS = ["phi4-mini-3.8b-smoke",   # MHA
         "gemma2-27b-smoke",       # GQA + local attention
         "zamba2-2.7b-smoke",      # hybrid attn/SSM
         "mamba2-780m-smoke"]      # pure SSM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test workers' for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(arch):
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg), \
        jcfg, jp


def drive(mod, eng, vocab, n_req=6, prompt_len=10, max_new=5, shared=4):
    rng = np.random.default_rng(0)
    base = list(map(int, rng.integers(1, vocab, shared)))
    reqs = [mod.Request(i, prompt=base + list(map(int, rng.integers(
        1, vocab, prompt_len - shared))), max_new=max_new)
        for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(map(int, r.out)) for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_megastep_token_parity(arch):
    cfg, params, jcfg, jp = model(arch)
    kw = dict(batch_slots=8, max_len=32, params=params, paged=True,
              page_size=4, device="cpu")
    eng_m = t_engine.ServeEngine(
        cfg, mesh=make_mesh((2, 4), ("data", "model"), "cpu"),
        megastep_k=4, **kw)
    assert "4-token megastep" in eng_m.explain_dispatch()
    assert eng_m.sharded_kernel and eng_m.pool.spec.n_shards == 2
    out_m = drive(t_engine, eng_m, cfg.vocab_size)
    assert eng_m.row_dispatches / max(eng_m.row_tokens, 1) <= 1.0
    out_1 = drive(t_engine, t_engine.ServeEngine(cfg, **kw), cfg.vocab_size)
    out_j = drive(jax_engine, jax_engine.ServeEngine(
        jcfg, batch_slots=8, max_len=32, params=jp, paged=True,
        page_size=4), cfg.vocab_size)
    assert out_m == out_1 == out_j, (arch, out_m, out_1, out_j)
    assert all(len(t) == 5 for t in out_m), out_m
    eng_m.pool.assert_consistent()


def test_megastep_pipeline_survives_revoke_restore():
    """Revoke 2 of the 8 positions mid-run (grace deadline) and restore
    them later while the engine runs megasteps through the double-buffered
    pipeline: zero drops, the unfaulted run's tokens, the JAX reference's,
    two re-homes and an empty pipeline at the end."""
    cfg, params, jcfg, jp = model("phi4-mini-3.8b-smoke")
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, 7)))
               for _ in range(8)]
    kw = dict(batch_slots=4, max_len=32, paged=True, page_size=4,
              prefill_chunk=3)

    def run(script):
        eng = t_engine.ServeEngine(
            cfg, params=params, device="cpu", megastep_k=4,
            mesh=make_mesh((4, 2), ("data", "model"), "cpu"), **kw)
        reqs = [t_engine.Request(i, prompt=list(p), max_new=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        inj = FaultInjector.parse(script) if script else None
        steps = 0
        while not eng.idle and steps < 2000:
            if inj is not None:
                for ev in inj.due(steps):
                    eng.inject(ev)
            eng.step()
            steps += 1
        assert eng.idle, "drained"
        return eng, reqs

    _, ref = run("")
    eng, got = run("revoke@4+2:2,restore@9")
    jeng = jax_engine.ServeEngine(jcfg, params=jp, **kw)
    jreqs = [jax_engine.Request(i, prompt=list(p), max_new=6)
             for i, p in enumerate(prompts)]
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    assert all(r.done for r in got), [r.uid for r in got if not r.done]
    assert not eng.rejected, "zero dropped requests"
    assert [r.out for r in got] == [r.out for r in ref] == \
        [list(map(int, r.out)) for r in jreqs], "token parity"
    assert eng.stats["rehomes"] == 2
    shapes = [e["mesh_shape"] for e in eng.elastic_log if "mesh_shape" in e]
    assert shapes == [{"data": 2, "model": 2}, {"data": 4, "model": 2}]
    # the in-flight megastep was flushed, not leaked, across both re-homes
    assert eng._inflight is None and eng._carry is None
    eng.pool.assert_consistent()
