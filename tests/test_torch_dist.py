"""The port's distribution layer against the JAX package's, on the CPU: twin
of ``tests/test_dist.py``'s five cases.

The JAX side needs an 8-device host mesh, so it runs once a file in one
8-device subprocess (``conftest.subproc``) that writes its arrays to an
npz and its specs to JSON; the port's side reads them and runs in
process on the same inputs (the JAX-initialised weights carried over
through numpy, the inputs drawn with numpy or saved by the JAX side).

* The sharded train step on (data 2, model 4) under ``"tp"``: the port's
  spec tree equals JAX's ``NamedSharding.spec`` leaf for leaf (a block's
  spec is JAX's less the stacked ``layers`` entry), its loss equals JAX's
  sharded run's within 1e-5 and its parameters are within the JAX test's
  rtol 5e-3 / atol 5e-4.
* MoE expert parallelism against JAX's at capacity factor 8 and at the
  config's own capacity factor (tokens shifted so the router's favourite
  experts overflow): outputs within rtol 2e-4 / atol 2e-5, the aux loss
  (each shard's, averaged over the token axes) within 1e-5, and every
  shard's keep mask equal to the one JAX's region routes. Then EP's
  training loss at the train step's aux coefficient 0.01 and its
  gradients, the router's included, against JAX's EP at both capacity
  factors; and EP's gradients on the int8 rung against the local int8
  MoE's.
* ``compressed_pmean`` with ``w`` split over the pods: equal to JAX's
  result within 1e-6; ``pod_sync_params`` exact on replicated params.
* The elastic reshard restore: the port's checkpoint of its parameters
  saved under (2, 4) ``fsdp_tp`` and restored for (4, 2) and (1, 8)
  ``tp``, bit-equal, the specs equal to JAX's restored shardings; and
  JAX's checkpoint restored into the port, bit-equal.
* The sequence-sharded decode cache: ``cache_shardings``' specs equal to
  JAX's leaf for leaf and the logits after four steps within the JAX
  test's 2e-3 of JAX's sharded decode.

Torch runs on one thread (a module fixture)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import api as jax_api
from repro_torch import configs as t_configs
from repro_torch.approx.knobs import PRECISE
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs.base import MoEConfig, ShapeConfig
from repro_torch.convert import (jax_path, named_from_numpy,
                                 params_from_numpy, tree_to_numpy)
from repro_torch.dist import collectives, sharding
from repro_torch.dist.sharding import P
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ParamTree
from repro_torch.train import optim
from repro_torch.train import step as step_mod

DENSE = "phi4-mini-3.8b-smoke"
MOE = "olmoe-1b-7b-smoke"
ELASTIC = "gemma2-27b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.ckpt import checkpoint as ck
from repro.configs import get_config
from repro.configs.base import MoEConfig, ShapeConfig
from repro.dist import annotate, sharding
from repro.dist.collectives import compressed_pmean, pod_sync_params
from repro.launch.mesh import make_mesh
from repro.models import api, lm
from repro.models import moe as moe_mod
from repro.models.common import init_params
from repro.train import optim, step as step_mod

out_path, ck_dir = %r, %r
res, meta = {}, {}


def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)


def flat(tree):
    return {"/".join(key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def spec(s):
    s = getattr(s, "spec", s)
    return [list(e) if isinstance(e, tuple) else e for e in s]


# 1. the sharded train step on (data 2, model 4) under tp
cfg = get_config("phi4-mini-3.8b-smoke")
params = api.init(cfg, jax.random.PRNGKey(0), jnp.float32)
opt = optim.init_opt(params)
tokens = np.random.default_rng(1).integers(
    0, cfg.vocab_size, (4, 33)).astype(np.int32)
batch = {"tokens": jnp.asarray(tokens)}
step = step_mod.make_train_step(cfg, remat="none")
mesh = make_mesh((2, 4), ("data", "model"))
annotate.set_batch_axes(("data",))
psh = sharding.param_shardings(cfg, mesh, "tp")
params_s = jax.device_put(params, psh)
opt_s = optim.OptState(step=jax.device_put(opt.step),
                       m=jax.device_put(opt.m, psh),
                       v=jax.device_put(opt.v, psh))
with jax.set_mesh(mesh):
    p_sh, _, m_sh = jax.jit(step, in_shardings=(psh, None, None),
                            out_shardings=(psh, None, None))(
        params_s, opt_s, batch)
annotate.set_batch_axes(None)
res["step/tokens"] = tokens
res["step/loss"] = np.float32(m_sh["loss"])
for k, v in flat(p_sh).items():
    res["step/p/" + k] = np.asarray(v)
meta["step_specs"] = {k: spec(v) for k, v in flat(psh).items()}

# 2. MoE expert parallelism at capacity factor 8 and at the config's
base = get_config("olmoe-1b-7b-smoke")
mesh = make_mesh((2, 4), ("data", "model"))
for tag, moe_cfg, shape, shift in (
        ("cf8", MoEConfig(n_experts=8, top_k=2, capacity_factor=8.0),
         (2, 16), 0.0),
        ("cfg", base.moe, (4, 64), 1.0)):
    mcfg = dataclasses.replace(base, moe=moe_cfg)
    mp = init_params(moe_mod.moe_specs(mcfg), jax.random.PRNGKey(0),
                     jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1),
                          shape + (mcfg.d_model,), jnp.float32) + shift
    y_loc, _ = moe_mod.moe(mp, x, mcfg)
    with jax.set_mesh(mesh):
        y_ep, aux_ep = jax.jit(lambda p, x: moe_mod.moe(
            p, x, mcfg, ep_axis="model", mesh=mesh))(mp, x)
    x2 = x.reshape(-1, mcfg.d_model)
    t_loc = x2.shape[0] // 8
    E, k = mcfg.moe.n_experts, mcfg.moe.top_k
    C = moe_mod._capacity(t_loc, k, E, mcfg.moe.capacity_factor)
    keep = [moe_mod._route(x2[i * t_loc:(i + 1) * t_loc], mp["wg"], k, C,
                           E)[2] for i in range(8)]
    res[f"moe/{tag}/x"] = np.asarray(x)
    for n, v in mp.items():
        res[f"moe/{tag}/p/{n}"] = np.asarray(v)
    res[f"moe/{tag}/y_local"] = np.asarray(y_loc)
    res[f"moe/{tag}/y_ep"] = np.asarray(y_ep)
    res[f"moe/{tag}/aux_ep"] = np.float32(aux_ep)
    res[f"moe/{tag}/keep"] = np.stack([np.asarray(m) for m in keep])

# 3. compressed_pmean with w split over the pods; pod_sync_params
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
tree = {"w": jax.random.normal(jax.random.PRNGKey(0), (2, 64)),
        "b": jax.random.normal(jax.random.PRNGKey(1), (32,))}
with jax.set_mesh(mesh):
    f = jax.shard_map(lambda t: compressed_pmean(t, "pod"), mesh=mesh,
                      in_specs=({"w": P("pod", None), "b": P(None)},),
                      out_specs={"w": P("pod", None), "b": P(None)},
                      axis_names={"pod"}, check_vma=False)
    got = jax.jit(f)(tree)
pw = {"w": jax.random.normal(jax.random.PRNGKey(2), (8, 8))}
with jax.set_mesh(mesh):
    synced = jax.jit(lambda p: pod_sync_params(p, mesh))(pw)
for n in ("w", "b"):
    res["cp/in/" + n] = np.asarray(tree[n])
    res["cp/out/" + n] = np.asarray(got[n])
res["cp/sync_in"] = np.asarray(pw["w"])
res["cp/sync_out"] = np.asarray(synced["w"])

# 4. elastic reshard restore: JAX's checkpoint, and its restored specs
ecfg = get_config("gemma2-27b-smoke")
eparams = api.init(ecfg, jax.random.PRNGKey(0), jnp.float32)
mesh1 = make_mesh((2, 4), ("data", "model"))
p1 = jax.device_put(eparams,
                    sharding.param_shardings(ecfg, mesh1, "fsdp_tp"))
ck.save(ck_dir + "/step_1", p1, 1)
meta["elastic_specs"] = {}
for shape in [(4, 2), (1, 8)]:
    mesh2 = make_mesh(shape, ("data", "model"))
    sh2 = sharding.param_shardings(ecfg, mesh2, "tp")
    restored, _ = ck.restore(ck_dir + "/step_1",
                             jax.eval_shape(lambda: eparams), shardings=sh2)
    for a, b in zip(jax.tree.leaves(eparams), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    meta["elastic_specs"]["%%dx%%d" %% shape] = {
        k: spec(v.sharding) for k, v in flat(restored).items()}

# 5. the sequence-sharded decode cache
B, S = 4, 32
toks = np.random.default_rng(1).integers(
    0, cfg.vocab_size, (B, S)).astype(np.int32)
dstep = lambda p, t, pos, c: lm.decode_step(p, t, pos, c, cfg)
mesh = make_mesh((2, 4), ("data", "model"))
shp = ShapeConfig("t", S, B, "decode")
cache_sh, _ = sharding.cache_shardings(cfg, shp, mesh)
psh = sharding.param_shardings(cfg, mesh, "tp")
with jax.set_mesh(mesh):
    params_s = jax.device_put(params, psh)
    caches_s = jax.device_put(lm.init_caches(cfg, B, S, dtype=jnp.float32),
                              cache_sh)
    jstep = jax.jit(dstep, in_shardings=(psh, None, None, cache_sh),
                    out_shardings=(None, cache_sh))
    for i in range(4):
        logits, caches_s = jstep(params_s, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.full((B,), i, jnp.int32), caches_s)
res["dec/toks"] = toks
res["dec/logits"] = np.asarray(logits)
meta["cache_specs"] = {k: spec(v) for k, v in flat(cache_sh).items()}

# 6. EP's training loss (aux_coef 0.01, the train step's) and its grads
ep_tokens = np.random.default_rng(3).integers(
    0, base.vocab_size, (4, 33)).astype(np.int32)
res["eptrain/tokens"] = ep_tokens
mesh = make_mesh((2, 4), ("data", "model"))
for tag, moe_cfg in (
        ("cf8", MoEConfig(n_experts=8, top_k=2, capacity_factor=8.0)),
        ("cfg", base.moe)):
    tcfg = dataclasses.replace(base, moe=moe_cfg)
    tparams = api.init(tcfg, jax.random.PRNGKey(0), jnp.float32)

    def f(p, tcfg=tcfg):
        return lm.lm_loss(p, {"tokens": jnp.asarray(ep_tokens)}, tcfg,
                          ep_axis="model", mesh=mesh, remat="none")
    with jax.set_mesh(mesh):
        (loss, met), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
            tparams)
    res[f"eptrain/{tag}/loss"] = np.float32(loss)
    res[f"eptrain/{tag}/aux"] = np.float32(met["aux"])
    for k, v in flat(g).items():
        res[f"eptrain/{tag}/g/{k}"] = np.asarray(v)
np.savez(out_path, **res)
print("JAXDIST" + json.dumps(meta))
"""


@pytest.fixture(scope="module")
def jax_side(subproc, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_dist")
    (d / "ck").mkdir()
    out = subproc(_JAX % (str(d / "out.npz"), str(d / "ck")), devices=8)
    line = next(s for s in out.splitlines() if s.startswith("JAXDIST"))
    return dict(np.load(d / "out.npz")), json.loads(line[len("JAXDIST"):]), d


_PARAMS = {}


def port_params(arch):
    """(port cfg, the port's params carried over from JAX's init) a file."""
    if arch not in _PARAMS:
        tcfg = t_configs.get_config(arch)
        jp = jax_api.init(jax_configs.get_config(arch),
                          jax.random.PRNGKey(0), jnp.float32)
        _PARAMS[arch] = (tcfg, jax.tree.map(np.asarray, jp))
    tcfg, tree = _PARAMS[arch]
    return tcfg, params_from_numpy(tree, tcfg)


def _spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _jax_leaf(arrays, prefix, name, cfg):
    path, i = jax_path(name, cfg)
    a = arrays[prefix + "/".join(path)]
    return a if i is None else a[i]


def _check_specs(specs, jax_specs, cfg):
    """The port's {name: P} against JAX's {path: spec}: a stacked leaf's
    JAX spec less its leading ``layers`` entry."""
    assert specs
    for name, s in specs.items():
        path, i = jax_path(name, cfg)
        want = _spec(jax_specs["/".join(path)])
        assert s == (want if i is None else want[1:]), (name, s, want)


def test_sharded_train_step_matches_jax(jax_side):
    arrays, meta, _ = jax_side
    cfg, params = port_params(DENSE)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    psh = sharding.param_shardings(cfg, mesh, "tp")
    specs = sharding.named_specs(psh)
    assert set(specs) == set(dict(params.named_parameters()))
    _check_specs(specs, meta["step_specs"], cfg)
    assert specs["embed"] == P("model", None)
    step = step_mod.make_train_step(cfg, remat="none", mesh=mesh,
                                    param_pspecs=psh)
    assert step.grad_reduce is not None and not step.grad_reduce.pod_wire
    batch = {"tokens": torch.from_numpy(arrays["step/tokens"])}
    params, _, m = step(params, optim.init_opt(params), batch)
    np.testing.assert_allclose(float(m["loss"]), float(arrays["step/loss"]),
                               rtol=1e-5)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), _jax_leaf(arrays, "step/p/", name, cfg),
            rtol=5e-3, atol=5e-4, err_msg=name)


def _moe_case(arrays, tag):
    base = t_configs.get_config(MOE)
    moe_cfg = (MoEConfig(n_experts=8, top_k=2, capacity_factor=8.0)
               if tag == "cf8" else base.moe)
    cfg = dataclasses.replace(base, moe=moe_cfg)
    pre = f"moe/{tag}/"
    params = ParamTree({n: torch.from_numpy(arrays[pre + "p/" + n])
                        for n in ("wg", "wi_gate", "wi_up", "wo")})
    return cfg, params, torch.from_numpy(arrays[pre + "x"])


@pytest.mark.parametrize("tag", ["cf8", "cfg"])
def test_moe_ep_matches_jax(jax_side, tag):
    """EP against JAX's EP: the outputs, the aux loss and every shard's
    keep mask; at capacity factor 8 also the local MoE (nothing drops);
    at the config's factor some entries drop."""
    arrays, _, _ = jax_side
    cfg, params, x = _moe_case(arrays, tag)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    routing = []
    collectives.WIRE.reset()
    with torch.no_grad():
        y_ep, aux = moe_mod.moe(params, x, cfg, ep_axis="model", mesh=mesh,
                                routing=routing)
        y_loc, _ = moe_mod.moe(params, x, cfg)
    pre = f"moe/{tag}/"
    np.testing.assert_allclose(y_ep.numpy(), arrays[pre + "y_ep"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux), arrays[pre + "aux_ep"],
                               rtol=1e-5)
    keep = np.stack([k.numpy() for _, k in routing])
    np.testing.assert_array_equal(keep, arrays[pre + "keep"])
    assert [c for c, _ in routing] == collectives.positions(mesh)
    calls = {k: v for k, v in collectives.WIRE.since().items()
             if k[1] == "all_to_all"}
    assert list(calls) == [("model", "all_to_all")]
    assert calls["model", "all_to_all"][0] == 2
    if tag == "cf8":
        assert keep.all()
        np.testing.assert_allclose(y_ep.numpy(), y_loc.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(y_loc.numpy(), arrays[pre + "y_local"],
                                   rtol=2e-4, atol=2e-5)
    else:
        assert not keep.all()


def test_compressed_pmean_and_pod_sync(jax_side):
    arrays, _, _ = jax_side
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    tree = {n: torch.from_numpy(arrays["cp/in/" + n]) for n in ("w", "b")}
    specs = {"w": P("pod", None), "b": P(None)}
    per_position = collectives.shard(tree, mesh, specs)
    assert per_position[(1, 0, 1)]["w"].shape == (1, 64)
    got = collectives.unshard(
        collectives.compressed_pmean(per_position, mesh, "pod"), mesh,
        tree, specs)
    for n in ("w", "b"):
        np.testing.assert_allclose(got[n].numpy(), arrays["cp/out/" + n],
                                   rtol=1e-6, atol=1e-6)
    want = tree["w"].mean(0)
    for row in got["w"]:
        np.testing.assert_allclose(row.numpy(), want.numpy(), rtol=0.05,
                                   atol=0.02)
    pw = {"w": torch.from_numpy(arrays["cp/sync_in"])}
    synced = collectives.pod_sync_params(pw, mesh)
    np.testing.assert_array_equal(synced["w"].numpy(), arrays["cp/sync_in"])
    np.testing.assert_array_equal(synced["w"].numpy(), arrays["cp/sync_out"])


def _restore_like(tree):
    return ck._map(lambda a: ck.LeafShape(np.shape(a)), tree)


def test_elastic_reshard_restore(jax_side, tmp_path):
    """The port's checkpoint, saved under (2, 4) fsdp_tp and restored for
    (4, 2) and (1, 8) tp: bit-equal, with JAX's restored specs; JAX's
    checkpoint restores into the port bit-equal."""
    _, meta, d = jax_side
    cfg, params = port_params(ELASTIC)
    named = {k: p.detach() for k, p in params.named_parameters()}
    spec1 = sharding.named_specs(sharding.param_shardings(
        cfg, make_mesh((2, 4), ("data", "model"), "cpu"), "fsdp_tp"))
    assert any("data" in s for s in spec1.values())
    tree = tree_to_numpy(named, cfg)
    ck.save(tmp_path / "step_1", tree, 1)
    for shape in [(4, 2), (1, 8)]:
        mesh2 = make_mesh(shape, ("data", "model"), "cpu")
        specs = sharding.named_specs(sharding.param_shardings(cfg, mesh2,
                                                              "tp"))
        _check_specs(specs, meta["elastic_specs"]["%dx%d" % shape], cfg)
        restored, step = ck.restore(tmp_path / "step_1", _restore_like(tree))
        assert step == 1
        for name, a in named_from_numpy(restored, named, cfg).items():
            np.testing.assert_array_equal(a, named[name].numpy())
    jax_tree, step = ck.restore(d / "ck" / "step_1", _restore_like(tree))
    assert step == 1
    for name, a in named_from_numpy(jax_tree, named, cfg).items():
        np.testing.assert_array_equal(a, named[name].numpy())


def test_seq_sharded_decode_cache(jax_side):
    arrays, meta, _ = jax_side
    cfg, params = port_params(DENSE)
    B, S = 4, 32
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    shp = ShapeConfig("t", S, B, "decode")
    cache_sh, abstract = sharding.cache_shardings(cfg, shp, mesh)
    got = {f"{i}/{f}": s for i, c in enumerate(cache_sh)
           for f, s in zip(c._fields, c)}
    assert set(got) == set(meta["cache_specs"])
    for k, s in got.items():
        assert s == _spec(meta["cache_specs"][k]), (k, s)
    assert got["0/k"] == P(None, "data", "model", None, None)
    assert all(x.device.type == "meta" for c in abstract for x in c)
    toks = torch.from_numpy(arrays["dec/toks"])
    caches = lm.init_caches(cfg, B, S, dtype=torch.float32)
    with torch.no_grad():
        for i in range(4):
            logits, caches = lm.decode_step(
                params, toks[:, i:i + 1],
                torch.full((B,), i, dtype=torch.int32), caches, cfg)
    np.testing.assert_allclose(logits.numpy(), arrays["dec/logits"],
                               rtol=2e-3, atol=2e-3)


def _loss_and_grads(cfg, knobs, tokens, params=None, aux_coef=0.0, **kw):
    """The loss (the cross-entropy at ``aux_coef`` 0), the aux loss and
    the gradients, from ``params`` (seed-0 weights when None)."""
    from repro_torch.models import api as t_api
    if params is None:
        params = t_api.init(cfg, 0, torch.float32, "cpu")
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    loss, metrics = lm.lm_loss(params, {"tokens": tokens}, cfg, knobs,
                               remat="none", aux_coef=aux_coef, **kw)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    params.requires_grad_(False)
    return float(loss.detach()), float(metrics["aux"].detach()), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}


def _ep_train_cfgs(tag):
    """(port cfg, JAX cfg) of olmoe-1b-7b-smoke at capacity factor 8
    (``cf8``, 8 experts, top-2) or its own (``cfg``)."""
    from repro.configs.base import MoEConfig as JaxMoEConfig
    tcfg, jcfg = t_configs.get_config(MOE), jax_configs.get_config(MOE)
    if tag == "cf8":
        tcfg = dataclasses.replace(tcfg, moe=MoEConfig(
            n_experts=8, top_k=2, capacity_factor=8.0))
        jcfg = dataclasses.replace(jcfg, moe=JaxMoEConfig(
            n_experts=8, top_k=2, capacity_factor=8.0))
    return tcfg, jcfg


@pytest.mark.parametrize("tag", ["cf8", "cfg"])
def test_moe_ep_train_loss_matches_jax(jax_side, tag):
    """EP's training loss at the train step's aux coefficient (0.01: the
    aux loss and its gradient reach the router) and every gradient,
    each layer's router ``wg`` among them, against JAX's EP step on the
    same weights and tokens: loss and aux within 1e-5 relative, gradients
    within the JAX test's rtol 2e-4 / atol 2e-5."""
    arrays, _, _ = jax_side
    tcfg, jcfg = _ep_train_cfgs(tag)
    jp = jax_api.init(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    tokens = torch.from_numpy(arrays["eptrain/tokens"])
    loss, aux, grads = _loss_and_grads(tcfg, PRECISE, tokens, params,
                                       aux_coef=0.01, ep_axis="model",
                                       mesh=mesh)
    pre = f"eptrain/{tag}/"
    np.testing.assert_allclose(loss, arrays[pre + "loss"], rtol=1e-5)
    np.testing.assert_allclose(aux, arrays[pre + "aux"], rtol=1e-5)
    routers = [k for k in grads if k.endswith("moe.wg")]
    assert len(routers) == tcfg.n_layers
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(),
                                   _jax_leaf(arrays, pre + "g/", k, tcfg),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("rung", ["precise", "int8"])
def test_moe_ep_train_step_matches_local(rung):
    """The training forward and backward with the experts spread over
    ``model`` (mesh (data 2, model 4), ``ep_axis="model"``) at capacity
    factor 8 against the local MoE's, the aux term left out (under EP the
    aux loss is a per-shard statistic, held to JAX's above): the
    cross-entropy and its gradients within the JAX test's rtol 2e-4 /
    atol 2e-5 on precise; on the int8 rung (the experts' int8 backward run
    a shard) within ``test_torch_attn_train``'s int8 tolerances, 1e-4
    relative / 2e-4 absolute."""
    from repro_torch.approx.knobs import ApproxKnobs
    cfg, _ = _ep_train_cfgs("cf8")
    knobs = ApproxKnobs(matmul_precision="int8") if rung == "int8" else \
        ApproxKnobs()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32))
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    ce_l, _, g_l = _loss_and_grads(cfg, knobs, tokens)
    ce_e, aux_e, g_e = _loss_and_grads(cfg, knobs, tokens, ep_axis="model",
                                       mesh=mesh)
    assert np.isfinite(aux_e)
    rtol, atol = (2e-4, 2e-5) if rung == "precise" else (1e-4, 2e-4)
    np.testing.assert_allclose(ce_e, ce_l, rtol=rtol)
    for k, g in g_e.items():
        np.testing.assert_allclose(g.numpy(), g_l[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)
