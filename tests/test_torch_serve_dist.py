"""The port's serving engine under a mesh against the JAX package's, on the
CPU: twin of ``tests/test_serve_dist.py``.

phi4-mini-3.8b-smoke in fp32 (the JAX-initialised weights carried over
through numpy), 4 slots, max_len 32, chunks of 3, nine prompts of 7
tokens and 5 new: six served, a hot swap into the ``kv_quant`` rung, the
other three served. The port's engine with a (data 2, model 4) mesh (its
parameter specs under ``SERVE_POLICY``, "tp", the JAX engine's default)
gives the single-device engine's greedy streams and the
JAX engine's under the same mesh (its side runs in one 8-device
subprocess, ``conftest.subproc``); after the swap its rings are int8, its
recorded cache spec is the JAX engine's placement (None, "data",
"model", None, None) and some parameter spec carries "model". Torch runs
on one thread (a module fixture)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.dist import sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import serving_table
from repro_torch.models.attention import KVCache
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "phi4-mini-3.8b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [list(map(int, rng.integers(1, vocab, 7))) for _ in range(9)]


_JAX = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.launch.serve import serving_table
from repro.models import api
from repro.models.attention import KVCache
from repro.serve.engine import Request, ServeEngine

cfg = get_config("phi4-mini-3.8b-smoke")
params = api.init(cfg, jax.random.PRNGKey(0), jnp.float32)
table = serving_table(cfg, slots=4, max_len=32)
kvq = len(table) - 1
prompts = json.loads(%r)
eng = ServeEngine(cfg, batch_slots=4, max_len=32, params=params,
                  table=table, mesh=make_mesh((2, 4), ("data", "model")),
                  prefill_chunk=3)
reqs = [Request(i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
for r in reqs[:6]:
    eng.submit(r)
eng.run()
eng.set_variant(kvq)
for r in reqs[6:]:
    eng.submit(r)
eng.run()
specs = [list(c.k.sharding.spec) for c in eng.caches
         if isinstance(c, KVCache)]
print("JAXSERVE" + json.dumps(dict(
    streams=[[int(t) for t in r.out] for r in reqs], specs=specs,
    names=[v.name for v in table.variants])))
"""


@pytest.fixture(scope="module")
def jax_side(subproc):
    vocab = jax_configs.get_config(ARCH).vocab_size
    out = subproc(_JAX % json.dumps(_prompts(vocab)), devices=8)
    line = next(s for s in out.splitlines() if s.startswith("JAXSERVE"))
    return json.loads(line[len("JAXSERVE"):])


def _run(cfg, params, table, mesh):
    eng = ServeEngine(cfg, batch_slots=4, max_len=32, params=params,
                      table=table, mesh=mesh, prefill_chunk=3,
                      device="cpu")
    reqs = [Request(i, prompt=p, max_new=5)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    for r in reqs[:6]:
        eng.submit(r)
    eng.run()
    eng.set_variant(len(table) - 1)
    for r in reqs[6:]:
        eng.submit(r)
    eng.run()
    return eng, [list(map(int, r.out)) for r in reqs]


def test_sharded_engine_matches_single_device(jax_side):
    cfg = t_configs.get_config(ARCH)
    jp = jax_api.init(jax_configs.get_config(ARCH), jax.random.PRNGKey(0),
                      jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    table = serving_table(cfg, slots=4, max_len=32)
    assert table.variants[-1].knobs.kv_quant
    assert [v.name for v in table.variants] == jax_side["names"]
    eng_ref, ref = _run(cfg, params, table, None)
    assert eng_ref.param_specs is None and eng_ref.cache_specs is None
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    eng, got = _run(cfg, params, table, mesh)
    assert got == ref
    assert got == jax_side["streams"]
    assert eng.sharded_prefill
    kv = [(c, s) for c, s in zip(eng.caches, eng.cache_specs)
          if isinstance(c, KVCache)]
    assert kv
    for c, s in kv:
        assert c.k.dtype == torch.int8              # converted under mesh
        assert s.k == (None, "data", "model", None, None)
    assert [list(s.k) for _, s in kv] == jax_side["specs"]
    specs = sharding.named_specs(eng.param_specs)
    assert set(specs) == set(dict(eng.params.named_parameters()))
    assert any("model" in s for s in specs.values())
