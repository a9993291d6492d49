"""The port's sharded paged decode against the JAX package's, on the CPU:
twin of ``tests/test_sharded_decode.py``'s 6 cases, plus the sharded
write-and-attend itself against JAX's ``paged_decode_attention``.

* For all four smoke archs, the port's engine under mesh 2x4 (2
  slot-affinity shards, one ``paged_attention`` call a shard a layer: the
  kernel's plain version here) gives the port's single-device engine's
  tokens and the JAX ``ServeEngine(paged=True, use_kernel=False)``'s,
  with ``kernel_sharded`` counted and never ``gather_mesh`` where the arch
  has attention.
* The loud fallback (a mesh with no plan: slots or pages that do not
  split over the batch axes), ``explain_dispatch``, and the plan and its
  reasons held to JAX's ``paged_decode_plan`` on the same ``FakeMesh``
  grid.
* The byte accounts, equal to JAX's.
* The sharded write-and-attend (JAX's ``_sharded_write_attend``), through
  ``paged_decode_attention`` under a mesh, fp32 and int8 K/V and a window
  with a softcap, against the JAX single-device
  ``paged_decode_attention(..., use_kernel=False)``: outputs
  within 1e-5, the new caches equal but on the null pages, where the port
  parks inactive rows' writes (the shard's own null page) and JAX drops
  them. The gather path (``shards=None``) against the same JAX output.

Torch runs on one thread (a module fixture)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.dist.sharding import paged_decode_plan as jax_plan
from repro.kernels import paged_attention as jax_pa
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.serve import engine as jax_engine
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_numpy
from repro_torch.dist.sharding import batch_axes, paged_decode_plan
from repro_torch.kernels import paged_attention as t_pa
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ParamTree
from repro_torch.serve import engine as t_engine

ARCHS = ["phi4-mini-3.8b-smoke",   # MHA
         "gemma2-27b-smoke",       # GQA + local attention
         "zamba2-2.7b-smoke",      # hybrid attn/SSM
         "mamba2-780m-smoke"]      # pure SSM
ATOL = 1e-5


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


def requests(mod, vocab, n_req=6, prompt_len=10, max_new=5, shared=4):
    """The JAX test's ``drive`` workload: 6 prompts sharing a 4-token
    prefix."""
    rng = np.random.default_rng(0)
    base = list(map(int, rng.integers(1, vocab, shared)))
    return [mod.Request(i, prompt=base + list(map(int, rng.integers(
        1, vocab, prompt_len - shared))), max_new=max_new)
        for i in range(n_req)]


def drive(mod, eng, vocab):
    reqs = requests(mod, vocab)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(map(int, r.out)) for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_token_parity(arch):
    cfg, params, jcfg, jp = model(arch)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    attn_mod.DISPATCH_COUNTS.clear()
    eng_s = t_engine.ServeEngine(cfg, batch_slots=8, max_len=32,
                                 params=params, mesh=mesh, paged=True,
                                 page_size=4, device="cpu")
    assert eng_s.sharded_kernel, arch
    assert "one launch per shard over 'data' (2 slot-affinity shards" in \
        eng_s.explain_dispatch(), eng_s.explain_dispatch()
    assert eng_s.pool.spec.n_shards == 2
    out_s = drive(t_engine, eng_s, cfg.vocab_size)
    counts = dict(attn_mod.DISPATCH_COUNTS)
    if any(k != "mamba" for k in cfg.pattern):
        assert counts.get("kernel_sharded", 0) > 0, (arch, counts)
    assert counts.get("gather_mesh", 0) == 0, (arch, counts)
    assert counts.get("kernel_single", 0) == 0, (arch, counts)
    eng_1 = t_engine.ServeEngine(cfg, batch_slots=8, max_len=32,
                                 params=params, paged=True, page_size=4,
                                 device="cpu")
    out_1 = drive(t_engine, eng_1, cfg.vocab_size)
    eng_g = jax_engine.ServeEngine(jcfg, batch_slots=8, max_len=32,
                                   params=jp, paged=True, page_size=4,
                                   use_kernel=False)
    out_g = drive(jax_engine, eng_g, cfg.vocab_size)
    assert out_s == out_1 == out_g, (arch, out_s, out_1, out_g)
    assert all(len(t) == 5 for t in out_s), out_s
    eng_s.pool.assert_consistent()


@pytest.mark.parametrize("why", ["pages-off", "no-plan"])
def test_mesh_gather_fallback_is_loud(why, capsys):
    """A page count or slots that do not split over the batch axes: no
    plan, so the gather path, counted, with its one-line warning once per
    reason; the tokens are the single-device engine's."""
    cfg, params, _, _ = model("gemma2-27b-smoke")
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    kw = (dict(batch_slots=8, n_pages=13) if why == "pages-off"
          else dict(batch_slots=3))
    attn_mod.DISPATCH_COUNTS.clear()
    attn_mod._GATHER_WARNED.clear()
    eng = t_engine.ServeEngine(cfg, max_len=32, params=params, mesh=mesh,
                               paged=True, page_size=4, device="cpu", **kw)
    assert not eng.sharded_kernel
    assert "gather" in eng.explain_dispatch(), eng.explain_dispatch()
    outs = []
    for e in (eng, t_engine.ServeEngine(cfg, max_len=32, params=params,
                                        paged=True, page_size=4,
                                        device="cpu", **kw)):
        r = t_engine.Request(0, prompt=list(range(1, 9)), max_new=3)
        e.submit(r)
        e.run()
        outs.append(r.out)
    assert len(outs[0]) == 3 and outs[0] == outs[1]
    counts = dict(attn_mod.DISPATCH_COUNTS)
    assert counts.get("gather_mesh", 0) > 0, counts
    assert counts.get("kernel_sharded", 0) == 0, counts
    err = capsys.readouterr().err
    assert err.count("paged decode under a mesh is taking the dense "
                     "gather path") == 1, err
    assert ("n_pages=13 does not split" if why == "pages-off"
            else "batch_slots=3 does not divide") in err


def test_explain_dispatch_single_device():
    """The kernel on one device, and the gather fallback with JAX's reason
    under a mesh that has no plan."""
    cfg = t_configs.get_config("gemma2-27b-smoke")
    jcfg = jax_configs.get_config("gemma2-27b-smoke")
    s = attn_mod.explain_dispatch(cfg, None, batch_slots=4)
    j = jax_attn.explain_dispatch(jcfg, None, batch_slots=4, use_kernel=True)
    assert "single device" in s and "single device" in j
    assert "paged_attention" in s and "fused" in j
    assert "gather" not in s and "gather" not in j
    mesh = FakeMesh({"data": 2, "model": 4})
    s = attn_mod.explain_dispatch(cfg, mesh, batch_slots=3)
    j = jax_attn.explain_dispatch(jcfg, mesh, batch_slots=3, use_kernel=True)
    assert "gather FALLBACK" in s and "gather FALLBACK" in j
    assert s.split(" — ")[1] == j.split(" — ")[1], (s, j)
    s = attn_mod.explain_dispatch(cfg, None, batch_slots=4, device="cuda",
                                  megastep_k=4)
    assert "fused CUDA paged_attention kernel" in s and "4-token" in s


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


PLAN_MESHES = [None, {"model": 4}, {"data": 2, "model": 4},
               {"data": 4, "model": 2}, {"data": 8, "model": 1},
               {"data": 3, "model": 2}, {"pod": 2, "data": 4, "model": 2},
               {"pod": 2, "data": 2}, {"pod": 4, "data": 1, "model": 8}]


@pytest.mark.parametrize("arch", ["gemma2-27b-smoke", "phi4-mini-3.8b",
                                  "zamba2-2.7b-smoke"])
def test_plan_infeasible_reasons(arch):
    """``paged_decode_plan`` gives JAX's plans and reasons on every mesh of
    the grid, slot count and page count; the engine's batch axes are
    ``batch_pspec``'s."""
    from repro.dist.sharding import batch_pspec
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    reasons = set()
    for shape in PLAN_MESHES:
        mesh = None if shape is None else FakeMesh(shape)
        for slots in (1, 2, 3, 4, 8, 16):
            for n_pages in (0, 36, 48, 72):
                tp, tr = paged_decode_plan(tcfg, mesh, slots, n_pages)
                jp, jr = jax_plan(jcfg, mesh, slots, n_pages)
                assert tr == jr and repr(tp) == repr(jp), \
                    (shape, slots, n_pages)
                reasons.add(tr)
            if mesh is not None:
                spec = batch_pspec(slots, mesh)
                assert batch_axes(slots, mesh) == \
                    (spec[0] if len(spec) else None)
    plan, reason = paged_decode_plan(tcfg, None, 8)
    assert plan is None and "single device" in reason
    plan, reason = paged_decode_plan(tcfg, FakeMesh({"model": 4}), 8)
    assert plan is None and reason
    assert any("does not split" in r for r in reasons)


def test_per_device_bytes_scale_with_live_pages_per_shard():
    G, hd, P, M, B = 2, 64, 8, 16, 8
    for n_shards in (2, 4):
        for live in (8, 32):
            kw = dict(n_shards=n_shards, batch=B, n_heads=4, max_pages=M)
            assert t_pa.sharded_decode_hbm_bytes(live, P, G, hd, **kw) == \
                jax_pa.sharded_decode_hbm_bytes(live, P, G, hd, **kw)
        sparse = t_pa.sharded_decode_hbm_bytes(8, P, G, hd, n_shards=n_shards,
                                               batch=B, n_heads=4,
                                               max_pages=M)
        dense = t_pa.sharded_decode_hbm_bytes(32, P, G, hd,
                                              n_shards=n_shards, batch=B,
                                              n_heads=4, max_pages=M)
        assert 2.0 < dense / sparse <= 4.0
        single = t_pa.decode_hbm_bytes(32, P, G, hd, batch=B, n_heads=4,
                                       max_pages=M)
        assert dense < single
        assert dense == pytest.approx(single / n_shards, rel=0.05)


def test_sharded_bytes_match_per_shard_account():
    live, P, G, hd, B, M, nsh = 24, 8, 2, 64, 8, 16, 4
    got = t_pa.sharded_decode_hbm_bytes(live, P, G, hd, n_shards=nsh,
                                        batch=B, n_heads=4, max_pages=M,
                                        kv_bytes=1)
    want = t_pa.decode_hbm_bytes(math.ceil(live / nsh), P, G, hd,
                                 batch=math.ceil(B / nsh), n_heads=4,
                                 max_pages=M, kv_bytes=1)
    assert got == want == jax_pa.sharded_decode_hbm_bytes(
        live, P, G, hd, n_shards=nsh, batch=B, n_heads=4, max_pages=M,
        kv_bytes=1)


# ----------------------------------------- the sharded write-and-attend --

# rows 0, 1 on shard 0 (pages 1-7), rows 2, 3 on shard 1 (pages 9-15);
# row 3 inactive. position, pages of the block row
ROWS = [(9, [3, 1, 6]), (5, [2, 7]), (13, [12, 9, 15, 10]), (2, [14])]
N_PAGES, PG, M = 16, 4, 4


def _pool(cfg, int8, seed=0):
    """A slot-affinity pool (2 shards of 8 pages) in numpy: random K/V
    on every page, each row's positions below its own in its pages."""
    rng = np.random.default_rng(seed)
    shape = (N_PAGES, PG, cfg.n_kv_heads, cfg.resolved_head_dim)
    if int8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kp = rng.normal(size=shape).astype(np.float32)
        vp = rng.normal(size=shape).astype(np.float32)
    ppos = np.full((N_PAGES, PG), -1, np.int32)
    block = np.zeros((len(ROWS), M), np.int32)
    for b, (pos, pages) in enumerate(ROWS):
        block[b, :len(pages)] = pages
        for lp, pid in enumerate(pages):
            for o in range(PG):
                if lp * PG + o < pos:
                    ppos[pid, o] = lp * PG + o
    return kp, vp, ppos, block


@pytest.mark.parametrize("case", ["fp32", "int8", "window-cap"])
def test_sharded_write_attend_matches_jax(case):
    arch = "gemma2-27b-smoke" if case == "window-cap" else \
        "phi4-mini-3.8b-smoke"
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    if case == "window-cap":
        jcfg, tcfg = (dataclasses.replace(c, attn_softcap=30.0)
                      for c in (jcfg, tcfg))
    window = 6 if case == "window-cap" else 0
    kv_scale = 0.05 if case == "int8" else 0.0
    jp = jax_common.init_params(jax_attn.attn_specs(jcfg),
                                jax.random.PRNGKey(1), jnp.float32)
    tp = ParamTree({k: torch.tensor(np.asarray(v)) for k, v in jp.items()})
    kp, vp, ppos, block = _pool(tcfg, case == "int8")
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(len(ROWS), 1, tcfg.d_model)) * 0.5).astype(
        np.float32)
    position = np.array([p for p, _ in ROWS], np.int32)
    active = np.array([True, True, True, False])

    jcache = jax_attn.PagedKVCache(*(jnp.asarray(a) for a in
                                     (kp, vp, ppos, block)))
    jo, jnew = jax_attn.paged_decode_attention(
        jp, jnp.asarray(x), jnp.asarray(position), jcache, jcfg,
        window=window, kv_scale=kv_scale, active=jnp.asarray(active),
        use_kernel=False)
    tcache = attn_mod.PagedKVCache(*(torch.from_numpy(a.copy()) for a in
                                     (kp, vp, ppos, block)))
    attn_mod.DISPATCH_COUNTS.clear()
    to, tnew = attn_mod.paged_decode_attention(
        tp, torch.from_numpy(x), torch.from_numpy(position), tcache, tcfg,
        window=window, kv_scale=kv_scale, active=torch.from_numpy(active),
        shards=2)
    assert attn_mod.DISPATCH_COUNTS == {"kernel_sharded": 1}
    live = [0, 1, 2]
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               atol=ATOL, rtol=0)
    keep = [p for p in range(N_PAGES) if p not in (0, 8)]
    for name, a, b in zip(("kp", "vp", "ppos"), tnew, jnew):
        a, b = a.numpy()[keep], np.asarray(b)[keep]
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                       err_msg=name)
        else:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() \
                <= (1 if name != "ppos" else 0), name
    # the inactive row (shard 1) parked its write on shard 1's null page
    assert int(tnew.ppos[8, position[3] % PG]) == position[3]
    assert torch.equal(tnew.block, torch.from_numpy(block))
    # and the per-shard calls give the single-device path's outputs
    single = attn_mod.PagedKVCache(*(torch.from_numpy(a.copy()) for a in
                                     (kp, vp, ppos, block)))
    so, _ = attn_mod.paged_decode_attention(
        tp, torch.from_numpy(x), torch.from_numpy(position), single, tcfg,
        window=window, kv_scale=kv_scale, active=torch.from_numpy(active))
    np.testing.assert_allclose(to.numpy()[live], so.numpy()[live],
                               atol=1e-6, rtol=0)
    # the gather path gives JAX's outputs too
    gather = attn_mod.PagedKVCache(*(torch.from_numpy(a.copy()) for a in
                                     (kp, vp, ppos, block)))
    go, _ = attn_mod.paged_decode_attention(
        tp, torch.from_numpy(x), torch.from_numpy(position), gather, tcfg,
        window=window, kv_scale=kv_scale, active=torch.from_numpy(active),
        shards=None)
    np.testing.assert_allclose(go.numpy()[live], np.asarray(jo)[live],
                               atol=ATOL, rtol=0)
