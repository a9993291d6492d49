"""The port's ring-attention chunked prefill against the JAX package, on the
CPU: ``ring_hop_plain`` (what CPU tensors take in ``ring_hop``) against the
Pallas ``_hop`` in interpret mode, ``ring_chunk_attention`` against the
JAX ``ring_chunk_attention(interpret=True)`` on meshes (2, 4) and (4, 1)
and against a masked-softmax oracle, ``prefill_plan`` and the cost account
against the JAX functions, and the port's ring engine token for token
against its single-device engine and the JAX ring engine on
phi4-mini-3.8b-smoke.

The JAX mesh needs forced host devices before ``jax`` is imported, so the
JAX ring and the JAX engines run in one subprocess (``conftest.subproc``,
8 devices); inputs and results cross through an npz in a temporary
directory. Tolerance: fp32, 1e-5 of the largest |acc| or |o| (the two
online softmaxes sum in other orders; measured below 1e-6); token streams
exactly equal."""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.dist.sharding import prefill_plan as jax_prefill_plan
from repro.kernels import ring_attention as jax_ring
from repro_torch import configs as t_configs
from repro_torch.dist.sharding import prefill_plan
from repro_torch.kernels import ring_attention as ra
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import attention as attn_mod

REL = 1e-5
CPU = torch.device("cpu")

# ------------------------------------------------------------ one hop --

HOP_CASES = {
    # name: (B, H, KVH, Cl, Ll, hd, window, cap, int8)
    "causal-gqa": (2, 4, 2, 40, 72, 16, 0, 0.0, False),
    "mha-blocks": (1, 2, 2, 128, 256, 32, 0, 0.0, False),
    "window-cap-gqa": (2, 6, 2, 40, 72, 16, 8, 30.0, False),
    "int8": (2, 4, 2, 40, 72, 16, 0, 0.0, True),
    "int8-window-cap-mqa": (1, 4, 1, 64, 96, 32, 16, 20.0, True),
}


def _hop_inputs(B, H, KVH, Cl, Ll, hd, int8, seed=0):
    """A hop with a carried non-trivial state, position holes (-1) on both
    sides, query rows that see nothing and rows still at the initial
    state."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, Cl, hd)) * 0.5).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (B, KVH, Ll, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, KVH, Ll, hd)).astype(np.int8)
    else:
        k = (rng.normal(size=(B, KVH, Ll, hd)) * 0.5).astype(np.float32)
        v = rng.normal(size=(B, KVH, Ll, hd)).astype(np.float32)
    qp = rng.integers(20, 120, (B, Cl)).astype(np.int32)
    qp[:, 3] = -1                      # empty query row
    qp[0, 5:9] = 0                     # rows seeing at most position 0
    kvp = rng.integers(0, 130, (B, Ll)).astype(np.int32)
    kvp[:, 10:20] = -1                 # hole
    kvp[kvp == 0] = 1                  # so rows at position 0 see nothing
    m = rng.normal(size=(B, H, Cl, 1)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (B, H, Cl, 1)).astype(np.float32)
    acc = rng.normal(size=(B, H, Cl, hd)).astype(np.float32)
    m[:, :, :4], l[:, :, :4], acc[:, :, :4] = -1e30, 0.0, 0.0
    return q, k, v, qp, kvp, m, l, acc


@pytest.mark.parametrize("name", list(HOP_CASES))
def test_ring_hop_plain_matches_pallas_interpret(name):
    B, H, KVH, Cl, Ll, hd, window, cap, int8 = HOP_CASES[name]
    kvs = 0.05 if int8 else 0.0
    arrs = _hop_inputs(B, H, KVH, Cl, Ll, hd, int8)
    want = jax_ring._hop(*(jnp.asarray(a) for a in arrs), window=window,
                         cap=cap, kv_scale=kvs, interpret=True)
    t = [torch.tensor(a) for a in arrs]
    got = ra.ring_hop(*t, window=window, cap=cap, kv_scale=kvs)
    assert got[0] is t[5] and got[2] is t[7]        # updated in place
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=REL * np.abs(w).max())
    # rows with nothing visible kept their carried state exactly
    seen = ra.visible(t[3], t[4], window).any(-1)            # (B, Cl)
    blind = ~seen[:, None, :].expand(B, H, Cl)
    np.testing.assert_array_equal(t[7][blind].numpy(),
                                  arrs[7][blind.numpy()])
    assert (~seen).any() and ra.launches == 0


def test_ring_hop_rejects_other_devices():
    from _torch_elsewhere import elsewhere
    t = [elsewhere(torch.zeros(1, 1, 1, 16))] * 3
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ra.ring_hop(*t, None, None, None, None, t[0])


# ----------------------------------------------- the ring, one chunk --

RING_CASES = {
    # name: (B, C, G, R, hd, L, window, cap, int8, q0)
    "striped-causal": (1, 10, 2, 2, 16, 42, 0, 0.0, False, 32),
    "striped-causal-cap": (1, 10, 2, 2, 16, 42, 0, 30.0, False, 32),
    "window-contiguous": (1, 10, 2, 2, 16, 42, 8, 0.0, False, 32),
    "window-cap": (1, 10, 2, 2, 16, 42, 8, 30.0, False, 32),
    "ragged": (1, 7, 2, 2, 16, 37, 0, 0.0, False, 26),
    "ragged-int8": (1, 7, 2, 2, 16, 37, 0, 0.0, True, 26),
    "int8": (1, 10, 2, 2, 16, 42, 0, 0.0, True, 32),
    "batch2-int8-window": (2, 9, 2, 3, 16, 45, 6, 0.0, True, 30),
    "prompt-start-skips": (1, 12, 2, 2, 16, 48, 0, 0.0, False, 0),
}
MESHES = {"2x4": (2, 4), "4x1": (4, 1)}
# the (case, mesh) pairs also run through the JAX ring (each compiles its
# own interpret-mode shard_map, ~8 s): both layouts on both meshes
JAX_RING = [("striped-causal-cap", "2x4"), ("batch2-int8-window", "2x4"),
            ("ragged-int8", "4x1"), ("window-cap", "4x1")]


def _ring_inputs(B, C, G, R, hd, L, window, cap, int8, q0, seed=0):
    """q at positions q0.., a context of L positions with an unmapped hole
    and, past the chunk's end, entries not yet written (-1), as the engine
    gathers a block row."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, C, G, R, hd)) * 0.3).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (B, L, G, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, L, G, hd)).astype(np.int8)
    else:
        k = (rng.normal(size=(B, L, G, hd)) * 0.3).astype(np.float32)
        v = rng.normal(size=(B, L, G, hd)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(q0, q0 + C), (B, C)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(L), (B, L)).astype(np.int32).copy()
    kv_pos[:, 5:9] = -1
    kv_pos[:, q0 + C:] = -1
    return q, k, v, q_pos, kv_pos


def _oracle(q, k, v, qp, kvp, window, cap, kv_scale):
    """The masked softmax of ``tests/test_ring_prefill.py``, in float64."""
    dq = (lambda a: a.astype(np.float64) * kv_scale) if kv_scale else \
        (lambda a: a.astype(np.float64))
    s = np.einsum("bcgrd,blgd->bgrcl", q.astype(np.float64), dq(k)) \
        * q.shape[-1] ** -0.5
    if cap:
        s = cap * np.tanh(s / cap)
    qe, ke = qp[:, None, None, :, None], kvp[:, None, None, None, :]
    mask = (ke >= 0) & (ke <= qe)
    if window:
        mask &= ke > qe - window
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bgrcl,blgd->bcgrd", p, dq(v))


# -------------------------------------------------- the JAX subprocess --

ARCH = "phi4-mini-3.8b-smoke"
ENGINE_KW = dict(batch_slots=8, max_len=32, page_size=4, prefill_chunk=8)
MAX_NEW = 4
# (mesh, rung) runs: every rung on (2, 4), precise on (4, 1)
ENGINE_RUNS = [("2x4", 0), ("2x4", 1), ("2x4", 2), ("4x1", 0)]


def _prompts(vocab, seed=0):
    """Four prompts of 10-17 tokens over chunks of 8 (ragged tails of 1 to
    5 tokens), three opening with one shared 4-token prefix."""
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(1, vocab, 4)]
    out = []
    for i, n in enumerate((10, 17, 11, 13)):
        tail = [int(t) for t in rng.integers(1, vocab, n - 4)]
        out.append(base + tail if i != 2 else tail + base)
    return out


_JAX_SIDE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.dist.sharding import prefill_plan
from repro.kernels.ring_attention import ring_chunk_attention
from repro.launch.mesh import make_mesh
from repro.launch.serve import serving_table
from repro.models import api
from repro.models import attention as attn_mod
from repro.serve.engine import Request, ServeEngine

d = dict(np.load(%(inp)r))
meta = json.loads(%(meta)r)
cfg = get_config(meta["arch"])
meshes = {k: make_mesh(tuple(v), ("data", "model"))
          for k, v in meta["meshes"].items()}
out = {}
for name, mk in meta["jax_ring"]:
    window, cap, kvs = meta["ring_cases"][name]
    C = d[name + ".q"].shape[1]
    plan, reason = prefill_plan(cfg, meshes[mk], C)
    assert plan is not None, reason
    o = ring_chunk_attention(
        *(jnp.asarray(d[name + "." + x])
          for x in ("q", "k", "v", "q_pos", "kv_pos")),
        mesh=meshes[mk], plan=plan, window=window, cap=cap, kv_scale=kvs,
        interpret=True)
    out[name + "@" + mk] = np.asarray(o, np.float32)

params = api.init(cfg, jax.random.PRNGKey(0), jnp.float32)
streams, counts = {}, {}
for mk, rung in meta["engine_runs"]:
    table = serving_table(cfg, slots=meta["kw"]["batch_slots"],
                          max_len=meta["kw"]["max_len"], page_occupancy=0.5)
    attn_mod.DISPATCH_COUNTS.clear()
    eng = ServeEngine(cfg, params=params, table=table, mesh=meshes[mk],
                      paged=True, use_kernel=True, kernel_interpret=True,
                      **meta["kw"])
    eng.request_variant(rung)
    reqs = [Request(i, prompt=list(p), max_new=meta["max_new"])
            for i, p in enumerate(meta["prompts"])]
    for r in reqs:
        eng.submit(r)
    eng.run()
    key = "%%s/%%d" %% (mk, rung)
    streams[key] = [list(map(int, r.out)) for r in reqs]
    counts[key] = dict(attn_mod.DISPATCH_COUNTS)
np.savez(%(res)r, **out)
print("JAXSIDE" + json.dumps(dict(streams=streams, counts=counts)))
"""


@pytest.fixture(scope="module")
def jax_side(subproc, tmp_path_factory):
    """Every JAX result this file compares with, from one subprocess."""
    tmp = tmp_path_factory.mktemp("ring")
    arrays, cases = {}, {}
    for name, c in RING_CASES.items():
        for x, a in zip(("q", "k", "v", "q_pos", "kv_pos"),
                        _ring_inputs(*c)):
            arrays[f"{name}.{x}"] = a
        cases[name] = (c[6], c[7], 0.05 if c[8] else 0.0)
    np.savez(tmp / "in.npz", **arrays)
    cfg = t_configs.get_config(ARCH)
    meta = dict(arch=ARCH, meshes=MESHES, ring_cases=cases,
                jax_ring=JAX_RING, kw=ENGINE_KW,
                engine_runs=ENGINE_RUNS, max_new=MAX_NEW,
                prompts=_prompts(cfg.vocab_size))
    out = subproc(_JAX_SIDE % dict(inp=str(tmp / "in.npz"),
                                   meta=json.dumps(meta),
                                   res=str(tmp / "out.npz")), devices=8)
    line = next(s for s in out.splitlines() if s.startswith("JAXSIDE"))
    return dict(np.load(tmp / "out.npz")), json.loads(line[len("JAXSIDE"):])


def _port_ring(name, mesh_shape):
    B, C, G, R, hd, L, window, cap, int8, q0 = RING_CASES[name]
    arrs = _ring_inputs(*RING_CASES[name])
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    plan, reason = prefill_plan(t_configs.get_config(ARCH), mesh, C)
    assert plan is not None, reason
    o = ra.ring_chunk_attention(*(torch.tensor(a) for a in arrs), mesh=mesh,
                                plan=plan, window=window, cap=cap,
                                kv_scale=0.05 if int8 else 0.0)
    return o.numpy(), arrs


@pytest.mark.parametrize("name,mesh_key", JAX_RING)
def test_ring_chunk_attention_matches_jax(jax_side, name, mesh_key):
    got, arrs = _port_ring(name, MESHES[mesh_key])
    want = jax_side[0][f"{name}@{mesh_key}"]
    assert got.shape == want.shape == arrs[0].shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_chunk_attention_matches_oracle(name, mesh_key):
    ra.hops_run = ra.hops_skipped = 0
    got, arrs = _port_ring(name, MESHES[mesh_key])
    c = RING_CASES[name]
    oracle = _oracle(*arrs, c[6], c[7], 0.05 if c[8] else 0.0)
    np.testing.assert_allclose(got, oracle, rtol=0,
                               atol=REL * np.abs(oracle).max())
    n = MESHES[mesh_key][0]
    assert ra.hops_run + ra.hops_skipped == n * n and ra.launches == 0
    if name == "prompt-start-skips":
        # the shards past the chunk hold only unwritten entries
        assert ra.hops_skipped >= n - 1, (ra.hops_run, ra.hops_skipped)


def test_ring_chunk_attention_needs_the_mesh_device():
    arrs = _ring_inputs(*RING_CASES["striped-causal"])
    mesh = make_mesh((2, 1), ("data", "model"), "meta")
    plan, _ = prefill_plan(t_configs.get_config(ARCH), mesh, 10)
    with pytest.raises(ValueError, match="mesh"):
        ra.ring_chunk_attention(*(torch.tensor(a) for a in arrs), mesh=mesh,
                                plan=plan)


# -------------------------------------------------- plans and meshes --

class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


PLAN_MESHES = [None, {"model": 4}, {"data": 1, "model": 8}, {"data": 64},
               {"data": 2, "model": 4}, {"data": 4, "model": 1},
               {"data": 8, "model": 3}, {"pod": 2, "data": 4, "model": 2},
               {"pod": 4, "data": 2, "model": 8}, {"pod": 16, "data": 2}]


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi4-mini-3.8b-smoke",
                                  "mamba2-780m"])
@pytest.mark.parametrize("shape", PLAN_MESHES, ids=str)
def test_prefill_plan_matches_jax(arch, shape):
    jcfg, tcfg = jax_configs.get_config(arch), t_configs.get_config(arch)
    mesh = None if shape is None else _FakeMesh(shape)
    for chunk in (1, 2, 3, 4, 7, 8, 16, 2048):
        jp, jr = jax_prefill_plan(jcfg, mesh, chunk)
        tp, tr = prefill_plan(tcfg, mesh, chunk)
        assert tr == jr, (shape, chunk)
        assert (tp is None) == (jp is None), (shape, chunk)
        if tp is not None:
            assert (tp.seq_axis, tp.n_shards, tp.kv_head_axis) == \
                (jp.seq_axis, jp.n_shards, jp.kv_head_axis)
            assert repr(tp) == repr(jp)


def test_prefill_plan_reasons_are_all_reached():
    cfg = t_configs.get_config("phi4-mini-3.8b")
    reasons = {prefill_plan(cfg, None if s is None else _FakeMesh(s), c)[1]
               for s in PLAN_MESHES for c in (1, 16)}
    assert "no mesh (single device)" in reasons
    assert any("no batch mesh axis" in r for r in reasons)
    assert any("shorter than every batch mesh axis" in r for r in reasons)


def test_mesh_shape_and_single_device_rule():
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    assert list(mesh.shape.items()) == [("data", 2), ("model", 4)]
    assert len(mesh.devices) == 8 and mesh.device == CPU
    with pytest.raises(NotImplementedError,
                       match="positions on several cards"):
        Mesh((2,), ("data",), ["cpu", "meta"])
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data", "model"), ["cpu"] * 3)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dims", [(2048, 16384, 24, 8, 128),
                                  (2048, 32768, 16, 8, 128),
                                  (100, 1000, 8, 4, 64), (7, 37, 4, 2, 16)])
def test_cost_functions_match_jax(dims, n):
    C, L, H, G, hd = dims
    assert ra.prefill_attn_flops(C, L, H, hd) == \
        jax_ring.prefill_attn_flops(C, L, H, hd)
    assert ra.sharded_prefill_attn_flops(C, L, H, hd, n_shards=n) == \
        jax_ring.sharded_prefill_attn_flops(C, L, H, hd, n_shards=n)
    for kvb, qb in ((4, 4), (2, 2), (1, 2)):
        kw = dict(n_heads=H, kv_bytes=kvb, q_bytes=qb)
        assert ra.prefill_hbm_bytes(C, L, G, hd, **kw) == \
            jax_ring.prefill_hbm_bytes(C, L, G, hd, **kw)
        assert ra.sharded_prefill_hbm_bytes(C, L, G, hd, n_shards=n, **kw) \
            == jax_ring.sharded_prefill_hbm_bytes(C, L, G, hd, n_shards=n,
                                                  **kw)
    assert ra.sharded_prefill_hbm_bytes(C, L, G, hd, n_shards=n,
                                        n_heads=H) == \
        ra.prefill_hbm_bytes(math.ceil(C / n), math.ceil(L / n), G, hd,
                             n_heads=H)


# ----------------------------------------------------------- engines --

@pytest.fixture(scope="module")
def port_model():
    import jax
    from repro.models import api as jax_api
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.serve import serving_table
    jcfg, tcfg = jax_configs.get_config(ARCH), t_configs.get_config(ARCH)
    jparams = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    table = serving_table(tcfg, slots=ENGINE_KW["batch_slots"],
                          max_len=ENGINE_KW["max_len"], page_occupancy=0.5)
    return tcfg, tparams, table


def _port_streams(port_model, rung, mesh):
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params, table = port_model
    eng = ServeEngine(cfg, params=params, table=table, device="cpu",
                      mesh=mesh, paged=True, **ENGINE_KW)
    eng.request_variant(rung)
    reqs = [Request(i, prompt=list(p), max_new=MAX_NEW)
            for i, p in enumerate(_prompts(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    eng.pool.assert_consistent()
    return eng, [list(map(int, r.out)) for r in reqs]


@pytest.mark.parametrize("mesh_key,rung", ENGINE_RUNS,
                         ids=[f"{m}-rung{r}" for m, r in ENGINE_RUNS])
def test_ring_engine_token_parity(jax_side, port_model, capsys, monkeypatch,
                                  mesh_key, rung):
    """Port ring engine == port single-device engine == JAX ring engine,
    token for token, with the ring dispatched (hops run) and every chunk
    shorter than the shard count (ragged tails; their lengths depend on
    which prefix pages were shared) taking the single-device path, counted
    per layer and warned once per length."""
    from repro_torch.serve import prefill as prefill_mod
    lengths = []
    chunk = prefill_mod.paged_prefill_chunk

    def recording(params, tokens, *a, **kw):
        lengths.append(tokens.shape[1])
        return chunk(params, tokens, *a, **kw)

    monkeypatch.setattr(prefill_mod, "paged_prefill_chunk", recording)
    n = MESHES[mesh_key][0]
    mesh = make_mesh(MESHES[mesh_key], ("data", "model"), "cpu")
    ra.hops_run = ra.hops_skipped = 0
    attn_mod.mesh_fallbacks = 0
    attn_mod._PREFILL_WARNED.clear()
    eng, ring = _port_streams(port_model, rung, mesh)
    err = capsys.readouterr().err
    ring_lengths = list(lengths)
    short = sorted({c for c in ring_lengths if c < n})
    _, single = _port_streams(port_model, rung, None)
    key = f"{mesh_key}/{rung}"
    assert ring == single == jax_side[1]["streams"][key], (ring, single)
    assert eng.sharded_prefill
    assert "ring attention over 'data'" in eng.explain_prefill_dispatch()
    assert eng.sharded_kernel and \
        "one launch per shard over 'data'" in eng.explain_dispatch()
    assert jax_side[1]["counts"][key].get("ring_prefill", 0) > 0
    n_layers = port_model[0].n_layers
    assert ra.hops_run > 0 and ra.launches == 0
    assert ra.hops_run + ra.hops_skipped == \
        n * n * n_layers * sum(c >= n for c in ring_lengths)
    assert short, ring_lengths
    assert attn_mod.mesh_fallbacks == \
        n_layers * sum(c < n for c in ring_lengths)
    assert "single-device path" in err
    for c in short:
        assert f"chunk_len={c} shorter" in err, (c, err)


def test_engine_mesh_must_share_the_engine_device(port_model):
    from repro_torch.serve.engine import ServeEngine
    cfg, params, table = port_model
    with pytest.raises(ValueError, match="mesh on meta"):
        ServeEngine(cfg, params=params, table=table, device="cpu",
                    mesh=make_mesh((2, 1), ("data", "model"), "meta"),
                    paged=True, **ENGINE_KW)


def test_serve_cli_mesh_banner(capsys):
    from repro_torch.launch import serve
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--paged",
                      "--mesh", "4x1", "--requests", "3", "--slots", "2",
                      "--max-new", "3", "--max-len", "48", "--page-size",
                      "4", "--prefill-chunk", "8", "--prompt-len", "9",
                      "--prompt-len-max", "30"])
    out = capsys.readouterr().out
    assert "dispatch: chunked prefill: ring attention over 'data' (4 " \
        "sequence shards" in out
    assert all(r.done for r in res["requests"])
    assert res["engine"].mesh.shape == {"data": 4, "model": 1}
